#!/usr/bin/env python3
"""Drive the PyTorch port (multi_view_stereonet_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and exits non-zero:

1. Device: a CUDA card is required. Prints ``nvidia-smi`` name and power
   limit, and the torch and CUDA versions.
2. Build: compiles the four hand-written kernels from ``csrc/``, one nvcc
   each, all started together.
3. Kernels vs their plain PyTorch versions on the card, TF32 off, at the
   serving path's shapes: the grid sample (480x640 min-idepth warp, and
   the 5-view level-4 plane sweep) within 1e-5 abs; the incremental chain
   (N = 1, 5 and 8, 30x40x32, D = 12) and the idepthmap refiner ((N, 35, h,
   w) = (N, 35, 30, 40) for N = 1, 2, 5, 8, and (1, 35, 60, 80)) within atol
   2e-5 * max|plain|, rtol 2e-4; the GroupNorm kernel at every GroupNorm
   shape of the forward (``GN_SHAPES``: resblock tails with the residual,
   bn0 and the 5-D cost filter without) within 1e-5 * max(1, max|plain|); also at
   the recipe's B = 8 shapes (``RECIPE_GN_SHAPES``) at f32 and bf16 (phase 11's bar),
   with their device time and bound.
   For each: a call's median ms over 20 timed runs after warm-up (CUDA
   events, host work included), and the device time alone (``graph_ms``:
   20 calls replayed from a CUDA graph), of kernel and plain version; the
   bound (the larger of the bytes read and written over 3.35 TB/s and the
   f32 operations over 67 TFLOP/s); for the grid sample also
   ``F.grid_sample``'s device time on the same data; for the chain the
   device time with 16- and with 8-block clusters forced. K1 also at the
   two-view losses' shapes, (8, 480, 640, 1) and (8, 480, 640, 3) sampled at a
   grid from ``project_idepthmap``, and at a grid holding NaN and +-inf: NaN
   outputs exactly where the plain version has them, equal flags, all else
   bit-equal.
4. Serving: a synthetic 480x640 GTA-SfM tree, a params.yaml (D = 12, cost
   filter on, five refiners) and seeded fan-in-scale weights saved as
   stereo_network.pth are served through StreamingRunner: four requests at
   B = 1, V = 1, then two at V = 2. Outputs must be finite, (B, 480, 640),
   and within 0.2% of the output range of the same batches served with
   impl="plain" on the card. The launch counters, zeroed just before the
   run, must show per forward two grid-sample launches, one chain, two
   refiner (levels 4 and 3) and 31 GroupNorm launches (the extractor's six
   resblocks, six resblocks and bn0 for each of refiners 2, 1 and 0, and
   the cost filter's four), and none on the plain path. Prints ms per
   frame of kernel and plain paths (B = 1, V = 1).
5. Eval: ``run_eval`` (the eval CLI) on the card, kernel and plain paths,
   over the V = 1 tree at batch 2 (four requests) and a 480x640 DeMoN tree
   (plane depth 4.0, one scene of each of two types, three frames each) at
   batch 1. Every output file is written, the loss is
   finite, the launch counters match each forward's B*V (warm-ups
   included), and every row of the kernel run is within the CPU tests'
   bars of the plain run's (a1-a3 1e-3 absolute, the other columns 1e-4
   relative, NaN equal to NaN). Then the kernel path over a LONG-request
   V = 1 tree at batch 1 and 2: median and mean runtime_ms per image.
6. Transport: all 256 uint8 values dequantized on the card bit-equal to the
   host pipeline; the V = 1 tree served at B = 1 and 4 from a uint8 dataset
   bit-equal to the float32 one, and with a float16 fetch equal to the
   float32 output cast; launches checked. Then depthmaps/s with the
   readback over the LONG-request tree, one runner a run, in turns f32 and
   u8 with four decode threads and f32 with one, twice: the median time
   between consecutive results in the steady window (start-up and drain left
   out) as ms a request, and the window's depthmaps/s.
3b. Backward of each kernel (its ``torch.autograd.Function``, which launches its
   backward kernel) at phase 3's shapes against plain autograd on the card: every input's
   gradient within 1e-4 of max|plain| (a gradient below 1e-4 of the largest held to that
   floor), no forward launch in the backward and its own backward's launches: one for
   K1's and K4's, two for K2's and K3's (the sequential part, then the weight-gradient
   pass, ``BACKWARD_PER``). K2 by ``chain_legs`` (CHAIN_LEGS' bars) and K3 (also at the recipe's
   (8,35,60,80)) by ``refiner_legs`` (REFINER_LEGS'): two legs, each within the bar (the
   Function against its closed form on what the kernel's forward kept, and that closed
   form on the plain forward's tensors against autograd through that forward), what the
   kernel's forward kept (out, raw h and r, statistics) against the plain forward's, the
   LeakyReLU branches the two forwards take apart (a GroupNorm value within their
   roundings of the kink) by count and |z|, and the direct gap to plain autograd within
   the bar where no branch flips. (K4's output gradient is 0 where its GroupNorm value
   lies within KINK_ROUNDING of LeakyReLU's kink, from f64 statistics, ``gn_kink_mask``:
   there the two forwards' roundings may take two branches; at most KINK_SHARE of the
   elements, or KINK_FLOOR.) Each backward kernel alone against its plain version
   (closed form) on the same inputs (K2, K3: what its forward kept; K4: the same
   statistics), within the same bar, with both device times (``graph_ms``) and its bound
   (K2 also timed for the recipe's gradients alone, feats0's and the weights'; K3's bound
   twice its forward's multiply-adds; the recompute it replaced, the plain forward under
   autograd then its backward, timed by CUDA graph and by torch.profiler, and one
   launch's device events at (1,35,60,80), and a second run bit-equal to the first); K2's
   and K3's weight-gradient pass alone against its plain version on the maps its
   sequential part kept, within the same bar, with both device times and its bound (the
   forward's convs' multiply-adds); the device time
   of one backward (torch.profiler, the sum of its kernels over two calls a session
   after one warm-up; ``profile_kernels`` keeps two sessions that agree on the count
   of kernel events), of the plain
   path's backward and, for K1 and K4, of ``F.grid_sample``'s and of
   ``F.group_norm`` + ``F.leaky_relu``'s. K1 also at the losses' shapes with image
   and grid both leaves, and at each of a two-view step's 20 calls (``k1_step_calls``:
   C = 1 at the five levels with both gradients, C = 3 at 480x640 with the grid's only),
   the kernel alone against its closed form with its device time and bound beside
   ``F.grid_sample``'s autograd for the same gradients (``backward_graph_ms``), and the
   sums a step. K2 comes last, its kernels timed by CUDA events around queued
   calls and its plain versions by torch.profiler, with no CUDA graph (``k2_section``).
7. Training at full width (the reference recipe: B = 8, V = 1, 480x640, D = 12,
   filter and five refiners on, adam 1e-3, augmentation on, 4 loader workers)
   through ``train_cli.train`` over the 96-request tree: 10 steps, validation
   over 16 images and an epoch checkpoint; a second call resumes it for 2
   steps (step count continued) and ``run_eval`` scores its checkpoint. Every
   loss finite; launches 2 / 1 / 2 / 31 a forward (train steps and validation
   batches), K4's backward kernel once a K4 forward launch of a step, K2's backward (two
   launches, one of them its weight-gradient pass) once a step, K3's once a fused refiner
   (twice a step), K1's none, and no forward launch from the backward; the CLI loop's ms a step (host clock
   between steps, loader included) and the loader's ms a batch alone. Then from
   one batch and the same seeded fan-in-scale weights, TF32 off: the kernel
   path's loss within 1e-5 relative of the plain path's and every gradient
   within docs/PARITY.md:218-232's bar; ms a train step (CUDA events, median
   after 2 warm-up steps, kernel and plain path in turns), images/s, peak
   memory (``max_memory_allocated``), the host and device time of the K3
   weight repack that each optimizer step causes, and on each path the device
   time of the forward alone and of one whole step (torch.profiler), with the
   top device operations of a kernel-path step, aten::native_group_norm's device
   time and calls (none on the kernel path), and K4's kernels' forward and backward
   device time.
8. The two-view recipe at full width (B = 8, 480x640, D = 12, filter and five
   refiners on, adam 1e-3, augmentation on; estimate_right_idepthmap with
   supervision / reconstruction / left-right factors 1.0 / 0.5 / 0.5, the JAX
   package's all-loss case): ``train_cli.train`` over the 96-request tree for 4
   steps, no validation (the JAX CLI's cannot run those losses), resumed for 1;
   losses.txt finite with the reconstruction and left-right columns; launches
   a step derived from the code (two forwards, and K1 12 + 20 + 10 times in the
   occlusion masks, left-right and reconstruction losses); from the backward no forward
   launch, K1's backward kernel 20 times (the left-right loss's two idepth samples a level
   and the reconstruction's two a level), K2's backward twice and K3's four times, two
   launches each (``expected_backward``). Then one
   batch, kernel path against plain: the loss within 1e-5
   relative and every gradient within phase 7's bar; ms a step (median of 6,
   CUDA events, the paths in turns after 2 warm-up steps each), peak memory, and
   a profile of one kernel-path step (device busy, the forward's device time, the
   top device operations).

9. Weights and the serving artifact: the phase-4 weights written again as a
   TorchScript archive with the reference's names (``tests/reference_archive.py``:
   the right extractor's shared copies, one strided parameter); ``run_eval`` from
   that ``stereo_network.pt`` writes the metric files of the ``.pth`` run, byte for
   byte (runtime files aside). The export CLI, from the ``.pt`` directory, writes
   the eval config's artifact (B = 1, V = 1, 480x640, D = 12, f32) and the
   production contract's (``--batch 24 --u8 --fetch float16``). Each is loaded in a
   fresh process (no weights, the network's modules not imported) and run once on
   the inputs the live ``StreamingRunner`` served: bit-equal outputs (f16 as bits),
   launches 2 / 1 / 2 / 31 at B = 1 and 2 / 1 / 0 / 45 at B = 24 (K3 takes
   n <= 8), the four custom ops in the graph (three at B = 24). Then the
   artifact's ms/frame against the live forward's, median of 20 after warm-up,
   in turns artifact, live, live, artifact; each custom op's host time a call
   against its launch code's called directly, as the eager forward does (the
   dispatcher's cost, which the artifact pays), and the launch code's device guard
   alone.
10. Multi-process training on the card, every process started as a subprocess with a
   time limit. (a) The train CLI as two processes over gloo on the one card
   (``--coordinator``; NCCL takes no two ranks on one device) at the recipe's width
   (global B = 8, four a process, 480x640, D = 12, adam) with augmentation off and one
   loader thread, for 3 steps, then relaunched to resume for 2: one checkpoint
   directory an epoch, and process 0's losses.txt against one process's
   ``train_step`` on the two processes' batches concatenated in rank order
   (``ShardedDataset`` 0 and 1, then ``BatchLoader``): within 1e-5 relative at step 1
   (from the init), step 4 (from the CLI's checkpoint) and step 5 (one update after
   it); steps 2 and 3, after adam's first updates from a zero second moment, which turn
   the last bits of a near-zero gradient into a whole step of the rate, within 1e-3,
   printed beside the drift of one process's kernel against its plain path. At every
   step, from the weights the two processes entered it with (each CLI process records
   them and the gradient it applies: ``record_training``), one process's loss on the same
   global batch within 1e-5 relative of losses.txt and its gradient against the applied
   one within phase 7's bar: no adam drift in between. (d) The CLI
   as two processes at
   the recipe (augmentation on, 4 loader threads a process) for 7 steps: each
   process's ms a step (host clock at its stop check, median of steps 4-6) beside
   phase 7's single-process loop, its peak memory, and its launches a step (2 / 1 / 2 /
   31 at four samples). (b) ``make_train_step`` on two processes against one: four
   samples each of (a)'s first global batch from the CLI's init, and ``mesh_view`` 2 (a
   view a process) at B = 2 V = 2; the loss identical on both, within 1e-5 of one
   process's, and every gradient within phase 7's bar. (c)
   NCCL at one process: join, a step through the mesh against one without, leave.
   NCCL across cards and a launch on a card other than the current one need more than
   one card: logged as not run. (e) One loader a view group: the train CLI as two
   processes at ``mesh_view`` 2 on an 80-request V = 2 tree at the recipe (B = 8,
   augmentation on), three runs in one spawn: 3 steps at 4 loader threads recording what
   each step trained on (``record_training``), where process 1 decodes no sample and
   every step's tensors on each process hash (SHA-256) to its share of the batch process
   0 loaded, and where, from the weights the two entered each step with, one process's
   loss on that batch is within 1e-5 relative and its gradient within phase 7's bar of
   theirs; then the CLI loop's ms a step (median of steps 4-6), at 1 and 4 loader
   threads in turn, with launches 2 / 1 / 2 / 31 a process-step.
11. The bf16 serving forward (``compute_dtype: bfloat16``). (a) Each kernel's bf16
   variant at phase 3's serving shapes against its plain version at bf16: K1's bf16
   output (f32 image in) bit-equal to the f32 kernel's output rounded; K4 (x and res
   bf16, the conv's bias as xbias) within one bf16 ulp of the f32 GroupNorm value plus
   one of the plain result plus the f32 floor (``GN_F32_FLOOR``) at every element, also
   at phase 15's shapes; K2 (N = 1 and 8, D = 12) within 5% of
   max|plain| and 2% of the f32 chain's max; K3 (level 4 at N = 1, 2, level 3) within
   1% of max|plain|, and after a bf16 launch the f32 launch equal to a cold-cache f32
   launch (the pack is kept per storage dtype); K2 and K3 also at phase 15's shapes
   (N = 4, 6x8x32; (4, 35, h, w) for refiners 4-1) with the same bars; each one's device
   time (``graph_ms``) at the serving shapes beside the f32 kernel's and its bound at
   bf16 bytes (operations at the bf16 tensor-core peak). (b) The V = 1 and
   V = 2 trees served through StreamingRunner at bf16 from zeroed counts: launches 2 /
   1 / 2 / 31 a forward, outputs f32 and finite; on each tree's first request, per
   pyramid level, max and mean |bf16 - f32| within 3% and 0.5% of the f32 level's
   range, and the bf16 kernel path within 2% of the bf16 plain path. (c) ms/frame at
   bf16 and f32 in turns (f32, bf16, bf16, f32) at B = 1 and 8, device-busy ms a
   forward (torch.profiler) and peak memory, recorded and claimed for nothing. (d) The
   eval CLI with ``compute_dtype: bfloat16`` in params.yaml over the V = 1 tree beside
   f32 (files written, abs_rel of both), and ``export --dtype bfloat16`` at B = 1 run
   in a fresh process bit-equal to the live runner at bf16, launches 2 / 1 / 2 / 31.
   A bar missed fails the phase after every measurement is printed.
12. Training at ``compute_dtype: bfloat16``. (a), run right after phase 3b (later in a
   long run torch.profiler was seen to miss most of a backward's kernel events): each
   kernel's ``autograd.Function`` at bf16 under gradients at phase 3b's shapes (K1 f32 image and grid, bf16 out; K2 bf16
   feats0; K3 bf16 guidance, f32 idepth; K4 bf16 x and res, the conv's bias as an f32
   xbias; the backward kernels alone as in phase 3b) against plain autograd at bf16
   within phase 3b's bar (K4 within phase 12's flat-gradient bar, 1e-2 of max|plain|: its
   kernel rounds its own f32 dx to bf16; the worst element's ulps printed; K2 by
   ``chain_legs``' bf16 bars, the direct gap to plain autograd at bf16 within 0.25 of
   max whatever the branches: its kernel differentiates its own forward, which warps in
   f32 as the Pallas kernel, and keeps its gradients f32, where the scan at bf16 warps at
   bf16 and autograd rounds every gradient to bf16 (the recipe trains alike under
   either, ROADMAP Queue 3); K2's kernel alone
   within 1e-2 of its closed form; K3 by ``refiner_legs``' bf16 bars, the direct gap
   within 1.0, its kernel alone within K3_BF16_BAR, 2e-2, of its closed form), with cuDNN
   and PyTorch
   deterministic for the comparison; every gradient at its input's dtype; the device
   times of the Function's backward, plain autograd's and the library call's (K1
   ``F.grid_sample``, K4 ``F.group_norm`` at bf16 + ``leaky_relu`` + add). (b) The
   recipe at bf16 through ``train_cli.train``: 3 steps, validation over 8 images, a
   checkpoint, a resume for 1 under ``remat_refiners``: losses finite, launches 2 / 1 /
   2 / 31 a forward (and the remat's recompute: K3 2, K4 21 a step), the weights and the
   checkpoint f32; the two-view recipe with every loss at bf16 for 2 steps, its launches
   as phase 8's. (c) One batch, kernel path against plain path at bf16: launches, the
   loss within 1e-4 relative and the flat gradient within 1e-2 relative L2 (bars from
   the phase's first chip run); with ``remat_refiners`` against without, the loss within
   1e-5 and the flat gradient within 1e-2; then ms a step, images/s and peak
   memory at f32 and bf16 on both paths in turns, device busy a kernel-path step at each
   dtype and K4's forward and backward kernels' share (torch.profiler), the K3 bf16
   repack's host time. (d) The train CLI as two
   processes over gloo at bf16 for 2 steps against one process's steps on the
   concatenated batches: step 1 within 1e-4, step 2 within 1e-3. A bar missed fails the
   phase after every measurement is printed.
13. The matmul-precision ladder (``matmul_precision: high``: cuDNN's convs at TF32, K2
   and K3 in their 1xTF32 variants). (a) Each 1xTF32 variant at phase 3's serving
   shapes against its TF32-rounding plain version (K2 within 1e-3, K3 within 3e-4 of
   max|plain|), and at phase 15's shapes (N = 4, 6x8x32; (4, 35, h, w) for refiners
   4-1), its error against the 3xTF32 kernel, the 3xTF32 kernel unchanged after
   it, device times (``graph_ms``) of both variants and of the plain version, the bound
   at TF32 (the convs' operations at the 494.7 TFLOP/s TF32 tensor-core peak); K2's
   backward at 1xTF32 (``check_backward_tf32``): the Function by ``chain_legs``' tf32
   bars against the TF32-rounding loop, the kernel alone (both launches) against its
   closed form at TF32 within 1e-3 and its weight-gradient pass alone against its plain
   version, two backward launches, and the device times of both backward variants; K3's
   the same (``check_refiner_backward_tf32``, ``refiner_legs``). (b) The
   forward at "high" against "highest" at B = 1 and 8, per level max within 1% and mean
   within 0.2% of the range; the kernel path within 0.5% of the plain path at "high";
   launches 2 / 1 / 2 / 31, of them 1xTF32 chain 1 and refiner 2; each stage alone at
   "high" (its deviation, its 1xTF32 launches); ms/frame in turns, device busy a
   forward, peak memory. (c) At "default" and "highest" the runner's output bit-equal
   with the caller's cuDNN TF32 flag on and off, and to phase 4's; the flag the caller's
   again after the call. (d) Training at "high", the recipe's batch with the caller's
   flag on: kernel path against plain path (loss within 1e-4, flat gradient within 1e-2
   relative L2), a spy on every conv's flags (the model's at TF32, cuBLAS's off) and on
   the losses'; ms a step, images/s, device busy and peak memory against "highest" in
   turns, and the device time of cuDNN's FFT kernels in a step at each; ``train()`` with
   ``matmul_precision: high`` for 2 steps (losses finite, checkpoint f32, launches).
   (e) The artifact exported at "high" run in a fresh process with the flag off, and at
   "highest" with the flag on: each bit-equal to the live forward at its precision, the
   flag restored. Then ``stage_precision: (("refiners", "high"),)`` at "highest", run in
   a fresh process with the flag off and in one with it on: bit-equal to the live forward
   at that config, the conv op ``mvs_torch::convolution`` in the graph, a spy on every
   conv (``conv_flags``) reading cuDNN's TF32 flag on at the refiners' convs and off at
   every other, K3 at 1xTF32 and K2 at 3xTF32, the flag restored. A bar missed fails the
   phase after every measurement is printed.
14. Replicas: ``StreamingRunner`` with the card named twice, two replicas each on a
   stream of its own. (a) K3's cooperative grid queued on two streams at once: ms a
   launch of a CUDA graph of launches on one stream and of one split over two parallel
   branches, in turns (do two grids share the card or run one at a time?), outputs
   bit-equal to a launch alone. (b) The V = 1 tree's four requests and
   its first again at batch 2 (two split steps, then the tail whole on replica 0)
   bit-equal to one replica at batch 1 over f32 and u8, the f16 fetch the f32 output
   cast, the launches of five B = 1 forwards, one grid-barrier counter (K3, K4) a replica
   stream, the caller's cuDNN TF32 flag unchanged (off, then on). (c) The LONG tree at B = 8 on
   one replica and on two, in turns: depthmaps/s with the readback and peak memory.
   Every wait on the card has a deadline (``Deadline``): a hang ends the run with exit
   code 1.
15. Convergence and the ladder (``convergence_phase``). (a) The convergence module
   (``train/convergence.py``, ``scripts/run_convergence_torch.py``'s) on Run A's tree and
   recipe (96x128 layered_track, 2 sequences x 10 frames, batch 4) for 3 epochs with a
   resume after 2: epochs and steps continued, losses finite, launches those of its
   forwards at 96x128 (K3 takes refiners 4-1). (b) The ladder (``eval/accuracy.py``) over
   Run A's committed weights (``docs/convergence_torch/layered_track``) on the held-out
   split, every config: those at "highest"'s modes bit-equal to it, and "highest"'s
   abs_rel and EPE within 1e-3 relative of the CPU's plain path's (``ladder_cpu.json``).

Phase 3 also holds K2 (N = 4, 6x8x32, the chosen cluster and 16 and 8 forced), K3
((4, 35, h, w) for refiners 4-1) and K4 (``CONV_GN_SHAPES``) at phase 15's shapes
against their plain versions, with phase 3's bars; phase 11 (a) their bf16 variants and
phase 13 (a) K2's and K3's 1xTF32 variants, which phase 15's "bf16" and "high" configs
reach there, with those phases' bars.

Every time and rate printed names the card and its power limit. Before the
last line it prints one JSON line with the kernels' names,
sources, launches, errors, times ("ms" and "plain_ms" are device times of
one call, "call_ms" and "plain_call_ms" a call's time with its host work),
bounds and library times (launches are phase 4's, "train_launches" phase
7's first ``train`` call's, "two_view_launches" one phase-8 step's,
"artifact_launches" and "artifact_launches_b24" phase 9's artifacts' in their
fresh processes; "op_call_us", "direct_call_us" and "guard_us" phase 9's dispatch
costs; "multi_process_launches" a process's launches a step in phase 10 (d);
"replica_launches" two replicas' over phase 14 (b)'s five requests;
"convergence_launches" phase 15 (a)'s), each
with a "backward" entry (phase 3b), a "bf16" entry (phase 11: its error, device
times, the f32 kernel's, its bound at bf16, the bar it met and its launches in phase
11 (b)), a "bf16_backward" entry (phase 12 (a), as "backward" at bf16) and
"bf16_train_launches" (a bf16 train step's, phase 12 (c)); K2's and K3's a "tf32" entry
(phase 13: the 1xTF32 variant's error against its plain version and, as a share of
max|plain|, against the 3xTF32 kernel, its device time beside the 3xTF32 kernel's in
the same call, its plain version's, its bound at TF32, the bar it met, its launches in
a forward at "high" and in a train step at "high"); K1's entry and its backward carry
"loss_shapes", one entry each for one and three channels at the losses' shapes. K4's
entry keeps "shapes" (every phase-3 shape's chunks a row and device times) and
"recipe_shapes" (the B = 8 shapes' device times at f32 and bf16). The K4 backward kernel
has an entry of its own ("group_norm_act_backward": launches phase
7's first ``train`` call's, "step_launches" one step's; its times phase 3b's, "bf16"
phase 12 (a)'s), and so have K1's and K2's ("grid_sample_backward": launches phase 8's
first ``train`` call's, "step_launches" one two-view step's, "shapes" each phase-3b
shape's times, "library_ms" ``F.grid_sample``'s backward at (1,480,640,3), "step_calls"
a two-view step's calls with their "needs", "calls", times, bound and "library_ms", and
their sums "step_ms", "step_bound_ms", "step_library_ms";
"incremental_chain_backward": launches phase 7's first ``train`` call's,
"step_launches" one step's, "two_view_launches" one two-view step's, "shapes" with
"recipe_ms", "tf32" phase 13's). Then the nvidia-smi line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WARP_BAR = 1e-5
BACKWARD_BAR = 1e-4  # times max(max|plain grad|, 1e-4 of the largest), phase 3b
BACKWARD_REPS = 2  # calls a profiler session of a backward's device time (3b, 12 (a))
# Training against the plain path (docs/PARITY.md:218-232): per parameter, max|diff|
# within 2.5e-3 of max|plain| and cosine > 0.999998; a leaf below 1e-4 of the
# largest held to that floor; the loss within 1e-5 relative.
GRAD_BAR, COS_BAR, GRAD_FLOOR, LOSS_BAR = 2.5e-3, 1 - 2e-6, 1e-4, 1e-5
TRAIN_B, TRAIN_STEPS, RESUME_STEPS, VAL_IMAGES = 8, 10, 2, 16
# Phase 8: the JAX package's all-loss case (tests/test_grad_parity.py:110-112).
TWO_VIEW_FACTORS = {"supervision_factor": 1.0, "reconstruction_factor": 0.5,
                    "left_right_factor": 0.5}
TWO_VIEW_STEPS, TWO_VIEW_RESUME = 4, 1
MP_PROCESSES, MP_STEPS, MP_RESUME = 2, 3, 2  # phase 10
# Phase 10 (e): steps of the recorded run at mesh_view 2, steps of each timed run, and
# the loader threads of the timed runs in turn.
VIEW_RECORD_STEPS, VIEW_STEPS, VIEW_TURNS = 3, 7, (1, 4)
# Phase 10 (d): steps of the timed two-process run at the recipe.
MP_TIMED_STEPS = 7
# Phase 10 (a): the loss after adam's first updates from the init, two processes against
# one; a wrong or reordered batch moves it by more than 1e-2 (the losses of consecutive
# steps differ by 10-70%).
DRIFT_BAR = 1e-3
NUM_LEVELS = 5
CHAIN_ATOL, CHAIN_RTOL = 2e-5, 2e-4  # also the idepthmap refiner's bar
GN_BAR = 1e-5  # times max(1, max|plain|)
SERVE_BAR = 2e-3  # fraction of the plain path's output range
# Eval rows, kernel path against plain path (tests/test_torch_eval.py's bars).
EVAL_REL_BAR, EVAL_DELTA_BAR = 1e-4, 1e-3
RATIOS = ("a1", "a2", "a3")
# The most torch.profiler sessions a reading takes: 16, as a run on the H100 saw seven of
# eight sessions of one reading hold no event.
PROFILE_SESSIONS = 16
PROFILE_SLACK = 8  # kernel events by which two sessions of one reading may differ
# The bound's peaks: NVIDIA H100 SXM data sheet, HBM3 rate and f32 outside the tensor
# cores (dense), at the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # bf16 on the tensor cores (the bf16 kernels' convs)
PEAK_TF32_FLOPS = 494.7e12  # TF32 on the tensor cores, dense (the 1xTF32 kernels' convs)
# Phase 11 (bf16 serving): K3 at bf16 within 1% of max|plain|. K2 within 5% of max|plain|
# at bf16 and within 2% of max|plain| of the f32 chain: the kernel rounds as the Pallas
# kernel does (the warp in f32) and the plain loop as the scan (the warp at bf16), and the
# eleven steps compound the difference (2.4% of max|plain| emulated on the CPU; the JAX
# scan at bf16 lies 2.4% from the f32 chain itself). The bf16 forward against the f32
# forward, per level, mean within 0.5% and max within 3% of the range (the range the JAX
# package's bf16 forward reads, docs/PARITY.md:157-160); the bf16 kernel path within 1%
# of the range of the bf16 plain path, widened to 2% (the chain's rounding difference
# reaches the soft-argmin: 0.90% measured at V=2). K4 at bf16 within one bf16 ulp of the
# GroupNorm's output and one of the result at each element, plus GN_F32_FLOOR of
# |x_hat * gamma| + |beta|: kernel and plain version differ only where their f32
# GroupNorm values round to different bf16s, and LeakyReLU's product and the residual's
# sum carry that difference on (a residual that cancels the branch makes it many ulps of
# the result). The two f32 values y = x_hat * gamma + beta (the kernel's from f64
# statistics, the plain version's from F.group_norm's f32 ones) differ by their own
# roundings, a few 2^-24 of those terms: where y nearly cancels that is more than a bf16
# ulp of y. Phase 11 logs, at each shape, the worst element without the floor (its y and
# its terms) and how often kernel and plain each give the bf16 tail of the f64 value.
BF16_KERNEL_BAR = 1e-2
GN_F32_FLOOR = 2.0 ** -21
# Phase 3b and 12 (a): K4's backward against plain autograd leaves out the elements whose
# GroupNorm value z lies within KINK_ROUNDING (|x_hat gamma| + |beta| + |mean rstd gamma|)
# of LeakyReLU's kink (z from f64 statistics): there the kernel's z (from f64 statistics)
# and F.group_norm's (from f32 ones) differ by their roundings, a few 2^-24 of those
# terms, and may take two branches (a slope of 1 against 0.2). At most KINK_SHARE of the
# elements, or KINK_FLOOR, are left out.
KINK_ROUNDING, KINK_SHARE, KINK_FLOOR = 2.0 ** -16, 1e-4, 8
BF16_CHAIN_BAR, BF16_CHAIN_F32_BAR = 5e-2, 2e-2
BF16_FORWARD_MEAN, BF16_FORWARD_MAX = 5e-3, 3e-2
BF16_PATH_BAR = 2e-2
# Phase 12 (bf16 training), bars set from the first chip run of the phase (NVIDIA H100
# 80GB HBM3, 700.00 W). The kernel path against the plain path at bf16 on one batch: the
# loss within 1e-4 relative (measured 1.17e-5) and the flat gradient within 1e-2
# relative L2 (measured 3.14e-3; K2's forward rounds the warp in f32, its plain loop at
# bf16). Two processes against one at bf16: step 1, from the init, within 1e-4
# (measured 2.94e-6: the per-sample convs at B = 4 and 8 round differently); step 2,
# after adam's first update, within DRIFT_BAR (measured 2.69e-4).
BF16_TRAIN_LOSS_BAR, BF16_TRAIN_GRAD_BAR = 1e-4, 1e-2
BF16_MP_BAR = 1e-4
BF16_TRAIN_STEPS, BF16_VAL_IMAGES, BF16_MP_STEPS, BF16_TWO_VIEW_STEPS = 3, 8, 2, 2
# Phase 13 (matmul_precision "high": cuDNN's TF32, K2 and K3 1xTF32), bars written before
# the phase's first chip run, one moved after it. K3's 1xTF32 kernel within 3e-4 of
# max|plain| of its TF32-rounding plain version: both round each conv operand to TF32,
# but their f32 sums run in another order, and a sum that lands by a tie rounds the other
# way as the next layer stages it (2^-11 of that value), which seven GroupNorm layers
# carry on (the first run read 0.79-1.06e-4 of max|plain| against a bar of 1e-4; the
# 3xTF32 kernel, 3e-7). K2's within 1e-3 (eleven steps compound the same). The forward
# at "high" against "highest", per level, max within 1% and mean within 0.2% of the
# range (phase 11 read 0.62-0.86% and 0.15-0.17% for bf16); the kernel path within 0.5%
# of the range of the plain path at "high" (the plain path's convs round their operands
# to TF32 inside cuDNN). Training at "high", kernel path against plain path: phase 12's
# bars.
TF32_K3_BAR, TF32_K2_BAR = 3e-4, 1e-3
TF32_FORWARD_MAX, TF32_FORWARD_MEAN = 1e-2, 2e-3
TF32_PATH_BAR = 5e-3
TF32_TRAIN_LOSS_BAR, TF32_TRAIN_GRAD_BAR = 1e-4, 1e-2
TF32_TRAIN_STEPS = 2
# K2's Function against plain autograd (``chain_legs``) in phase 3b (f32), 12 (a) (bf16)
# and 13 (tf32). Two forwards part by their roundings; where a GroupNorm value lies
# within them of LeakyReLU's kink the two take two branches (a slope of 1 against 0.2),
# and each backward is the gradient of its own forward. So each leg is held to "leg":
# the Function against its closed form on what the kernel's forward kept, and that
# closed form on the plain forward's tensors against autograd through that forward; what
# the kernel kept (out, raw h and r, the statistics) against the plain forward's within
# "forward"; the branches the two take apart to "flip_share" of the GroupNorm values (or
# KINK_FLOOR), each with |z| <= "flip_z"; and the direct gap within "direct" where no
# branch flips, at bf16 whatever the flips. f32: the flips read 0 and 7 (|z| <= 1.29e-5)
# at N = 1 and 8. tf32: 72 and 594 (8.5e-5 and 8.8e-5 of the values), the forward bar of
# phase 13. bf16: the scan at bf16 warps at bf16 and plain autograd rounds every gradient
# to bf16, where the kernel warps in f32 (the Pallas kernel's rounding) and keeps its
# gradients f32, so "direct" is set from the readings 5.97e-2 and 1.64e-1 (the JAX
# package's bf16 VJP is not kept; the bf16 recipe trains alike under either gradient,
# scripts/k2_bf16_convergence_torch.py, ROADMAP Queue 3); "leg" from the CPU's 4.4e-3
# and 7.2e-3 of the closed form against autograd through the rounded forward (the one
# rounds each conv's gradient operand to bf16, the other each conv's result); "forward"
# phase 11's bar.
CHAIN_LEGS = {
    "f32": {"leg": BACKWARD_BAR, "forward": 1e-4, "direct": BACKWARD_BAR, "flip_share": 1e-5,
            "flip_z": 1e-4},
    "tf32": {"leg": TF32_K2_BAR, "forward": TF32_K2_BAR, "direct": TF32_K2_BAR,
             "flip_share": 1e-3, "flip_z": 1e-2},
    "bf16": {"leg": 2e-2, "forward": BF16_CHAIN_BAR, "direct": 0.25, "flip_share": 1e-2,
             "flip_z": 1e-1}}
# K3's Function against plain autograd (``refiner_legs``) in phase 3b (f32), 12 (a)
# (bf16) and 13 (a) (tf32), as CHAIN_LEGS holds K2's: the Function against its closed form
# on what the kernel's forward kept, that closed form on the plain forward's tensors
# against autograd through that forward (``saved_forward``, whose conv output gradients
# are rounded as the closed form rounds them), what the kernel kept against the plain
# forward's, the LeakyReLU (and output ReLU) branches the two forwards take apart, the
# Function against autograd through that forward where none is apart, and the direct gap
# (to autograd through the module's plain forward) where the kernel's forward and that
# one take none apart (at bf16 always). Phase 3b's inputs over 32 draws
# (``scripts/k3_check_draws.py``, PERF.md §6): the direct gap passed 1e-4 on 9, each
# with 1-2 branches apart from the module's plain forward at |z| <= 1.32e-6; on two of
# them no branch was apart from ``saved_forward``. f32 and tf32: the chain's bars; the
# second leg read 1.2-4.2e-6 and 2.3-4.2e-4 on the CPU over four weight seeds at phase
# 3b's four shapes. bf16: the kernel's gradients are f32 where plain autograd rounds every
# one to bf16, and its forward keeps T f32 where the plain module rounds each conv's
# output, so the two forwards take 1-411 LeakyReLU branches apart and the direct gap is
# one of discrete effects: the CPU read 0.08-0.78 (closed form against plain autograd at
# bf16) over those sixteen cases, so "direct" is 1.0; the second leg, where autograd
# rounds to bf16 each gradient that crosses a bf16 value, read 7.7e-3 to 2.05e-2 there,
# so "leg" is 5e-2 (the first leg is also held to K3_BF16_BAR by the kernel alone).
# K3_BF16_BAR: the backward kernel alone against its closed form at bf16 (both f32 sums
# of bf16 products, in another order).
REFINER_LEGS = {
    "f32": CHAIN_LEGS["f32"],
    "tf32": CHAIN_LEGS["tf32"],
    "bf16": {"leg": 5e-2, "forward": BF16_CHAIN_BAR, "direct": 1.0, "flip_share": 1e-2,
             "flip_z": 1e-1}}
K3_BF16_BAR = 2e-2
H0, W0, D = 480, 640, 12
LONG = 96  # requests of the tree that phases 5, 6 and 14 time
REPLICA_DEADLINE = 120.0  # seconds any wait on the card in phase 14 may take
REPLICA_PROBE_CALLS = 100  # K3 launches a stream in phase 14 (a)
ARTIFACT_KEYS = ("left_image", "right_images", "K", "T_right_in_left")
# K4's shapes in the serving forward at B = 1, V = 1 (the filter also at V = 5).
GN_SHAPES = (((2, 32, 30, 40), True, "extractor resblocks, N = B + B*V"),
             ((1, 32, 120, 160), True, "refiner 2 resblocks"),
             ((1, 32, 240, 320), True, "refiner 1 resblocks"),
             ((1, 32, H0, W0), True, "refiner 0 resblocks"),
             ((1, 32, H0, W0), False, "refiner 0 bn0"),
             ((1, 32, D, 30, 40), False, "cost filter, N = B*V = 1"),
             ((5, 32, D, 30, 40), False, "cost filter, N = B*V = 5"))
# K4's shapes in a training step of the recipe (phase 7: B = 8, V = 1, 480x640, D = 12).
RECIPE_GN_SHAPES = (((2 * TRAIN_B, 32, 30, 40), True, "extractor resblocks"),
                    ((TRAIN_B, 32, 120, 160), True, "refiner 2 resblocks"),
                    ((TRAIN_B, 32, 240, 320), True, "refiner 1 resblocks"),
                    ((TRAIN_B, 32, H0, W0), True, "refiner 0 resblocks"),
                    ((TRAIN_B, 32, H0, W0), False, "refiner 0 bn0"),
                    ((TRAIN_B, 32, D, 30, 40), False, "cost filter"))
# Phase 15's convergence recipe (Run A of docs/convergence_torch: 96x128, B = 4, V = 1),
# its epochs and its resume, and the bar of its "highest" abs_rel against the CPU's.
CONV_SIZE, CONV_B, CONV_EPOCHS_FIRST, CONV_EPOCHS_TOTAL = (96, 128), 4, 2, 3
CONV_TAG, CONV_SEQUENCES, CONV_FRAMES, CONV_TREE_SEED = "layered_track", 2, 10, 7
CONV_ABS_REL_BAR = 1e-3
# K4's shapes in a training step of that recipe: the extractor's resblocks (N = B + B*V),
# refiner 0's resblocks and bn0 (refiners 4-1 go to K3), the cost filter (N = B*V).
CONV_GN_SHAPES = (((2 * CONV_B, 32, 6, 8), True, "96x128: extractor resblocks"),
                  ((CONV_B, 32) + CONV_SIZE, True, "96x128: refiner 0 resblocks"),
                  ((CONV_B, 32) + CONV_SIZE, False, "96x128: refiner 0 bn0"),
                  ((CONV_B, 32, D, 6, 8), False, "96x128: cost filter"))


def log(*args):
    print(*args, flush=True)


def k4_step_backward_bound() -> tuple:
    """(launches, ms): K4's backward launches in a recipe step (one a K4 forward launch:
    the extractor's six resblocks at N = B + B*V, six resblocks and bn0 for each of
    refiners 2, 1 and 0, the cost filter's four) and their bound, each launch reading x
    and the output's gradient and writing x's (the residual's gradient is the output's)
    at PEAK_BYTES_S."""
    calls = ([((2 * TRAIN_B, 32, 30, 40), 6)]
             + [((TRAIN_B, 32, H0 >> lvl, W0 >> lvl), 7) for lvl in (2, 1, 0)]
             + [((TRAIN_B, 32, D, 30, 40), 4)])
    elements = sum(math.prod(shape) * n for shape, n in calls)
    return sum(n for _, n in calls), 3 * 4 * elements / PEAK_BYTES_S * 1e3


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, runs=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps=20) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph, median of 7
    replays, divided by reps (no host work in the timed span)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return median_ms(graph.replay, runs=7, warmup=1) / reps


def backward_graph_ms(forward, leaves, reps=20) -> float:
    """Device time of one backward (``torch.autograd.grad``) of ``forward()``'s output:
    the forward once on a side stream, then ``reps`` backwards captured in a CUDA graph on
    that stream (a backward runs on its forward's stream), median of 7 replays, over
    reps."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = forward()
        cot = torch.randn_like(out)

        def call():
            return torch.autograd.grad(out, leaves, cot, retain_graph=True)
        for _ in range(3):
            call()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            call()
    return median_ms(graph.replay, runs=7, warmup=1) / reps


def queued_ms(fn, reps=20) -> float:
    """Device time of one call of a call that keeps the card busier than its host work
    takes to queue it: ``reps`` calls back to back between CUDA events, median of 7, over
    reps (no CUDA graph; the calls' host work overlaps the card's)."""
    def calls():
        for _ in range(reps):
            fn()
    return median_ms(calls, runs=7, warmup=1) / reps


def profile_kernels(fn, reps):
    """(device ms, wall ms, the profile) of one call of ``fn``: the card's kernel times
    summed under torch.profiler over ``reps`` calls a session, over reps (the gaps
    between kernels left out). Each session counts its device events, because a count
    moves (seen on the H100 machine): a session can miss some or all of its events
    (sporadic, 1-100% of them), and a session can hold one to six more than the others
    of its reading, or drift by one a session (a B=8 step read 26067, 26066, 26065 ...
    26061). So a session with no event is not kept, and a reading stands once two
    sessions agree on their count within PROFILE_SLACK events: the mean of those two.
    (Two sessions that miss the same number of events would pass; none was seen.) Raises
    after PROFILE_SESSIONS sessions without two that agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts, kept = [], []
    for _ in range(PROFILE_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        counts.append(len(times))
        if not times:
            continue
        session = (len(times), sum(times) / 1e3 / reps, wall)
        match = next((k for k in kept if abs(k[0] - session[0]) <= PROFILE_SLACK), None)
        if match is not None:
            if len(set(counts)) > 1:
                log(f"torch.profiler: kernel events by session {counts}; kept the two at "
                    f"{match[0]} and {session[0]}")
            return (match[1] + session[1]) / 2, (match[2] + session[2]) / 2, prof
        kept.append(session)
    raise AssertionError(f"torch.profiler: no two of {PROFILE_SESSIONS} sessions agreed on "
                         f"the kernel events of {reps} calls; by session {counts}")


def kernel_events(prof) -> list:
    """(name, ms) of each device event of a profile, in order, names cut to 48 characters."""
    from torch.autograd import DeviceType
    return [(e.name[:48], e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ms(fn, reps=5, warmup=2) -> float:
    """Device time of one call (``profile_kernels``) after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    return profile_kernels(fn, reps)[0]


def worst_relative(got, ref):
    """max over tensors of max|got - ref| / max(max|ref|, floor), the floor 1e-4 of the
    largest max|ref|."""
    floor = GRAD_FLOOR * max(r.abs().max().item() for r in ref)
    return max((g - r).abs().max().item() / max(r.abs().max().item(), floor)
               for g, r in zip(got, ref))


def scene(n, seed):
    """n left cameras (K at 480x640) and right poses like the GTA-SfM frames'."""
    rng = np.random.default_rng(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * W0
    K[0, 2], K[1, 2] = (W0 - 1) / 2.0, (H0 - 1) / 2.0
    Ts = []
    for _ in range(n):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(-0.05, 0.05)
        S = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + np.sin(angle) * S + (1 - np.cos(angle)) * (S @ S)
        T[:3, 3] = [rng.uniform(0.3, 0.5), rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05)]
        Ts.append(T)
    return (torch.from_numpy(np.repeat(K[None], n, 0)).cuda(),
            torch.from_numpy(np.stack(Ts).astype(np.float32)).cuda())


def conv_shape_inputs(dev, g, seed, dtype=torch.float32):
    """K2's and K3's inputs at phase 15's shapes (96x128, N = B = 4), f32 or ``dtype``
    where the kernel stores it: (level-4 chain inputs (feats0, image_rest, H_inc),
    [(refiner name, guidance, idepth) for refiners 4-1])."""
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        incremental_homographies, normalize_baseline)
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    K, T = scene(CONV_B, seed)
    T, _ = normalize_baseline(T)
    sizes = pyramid_sizes(*CONV_SIZE, NUM_LEVELS)
    K_pyr = build_K_pyramid(build_K_pyramid(K, [(H0, W0), CONV_SIZE])[1], sizes)
    H_inc = incremental_homographies(create_plane_sweep_homographies(
        T, K_pyr[4], create_idepth_samples(T, K_pyr[4], *sizes[4], D)))
    h4, w4 = sizes[4]
    feats0 = torch.randn(CONV_B, h4, w4, 32, generator=g).to(dev).to(dtype)
    image_rest = (torch.rand(CONV_B, D - 1, h4, w4, 3, generator=g) * 2 - 1).to(dev)
    refiners = []
    for lvl in (4, 3, 2, 1):
        h, w = sizes[lvl]
        guidance = (torch.rand(CONV_B, 35, h, w, generator=g) * 2 - 1).to(dev).to(dtype)
        refiners.append((f"refiner{lvl}", guidance,
                         (torch.rand(CONV_B, h, w, generator=g) * 20).to(dev)))
    return (feats0, image_rest, H_inc), refiners


def refiner_module(state, name, dev):
    """An ``IDepthmapRefiner`` holding ``state``'s weights of refiner ``name``, with
    version counters (made outside inference mode), as served."""
    from multi_view_stereonet_tpu_torch.models import IDepthmapRefiner
    with torch.inference_mode(False):
        module = IDepthmapRefiner(35)
        module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                if k.startswith(name + ".")})
        return module.to(dev).eval()


def loss_grid(n, dev, g, level=0):
    """The sampling grid of the two-view losses at pyramid level ``level`` (480x640 at 0,
    halved a level): a tilted-plane idepth map per sample (0.1-0.5, 1/m at a unit
    baseline) projected into the right camera by ``project_idepthmap`` (n, h, w, 2); a
    share of it falls outside the image."""
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, normalize_baseline, project_idepthmap)
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    K, T = scene(n, 20 + n)
    T, _ = normalize_baseline(T)
    sizes = pyramid_sizes(H0, W0, NUM_LEVELS)
    rows, cols = sizes[level]
    y = torch.linspace(0, 1, rows)[:, None]
    x = torch.linspace(0, 1, cols)[None, :]
    a, b, c = (torch.rand(3, n, 1, 1, generator=g) * 0.2).unbind(0)
    idepth = 0.1 + a + b * x + c * y
    return project_idepthmap(build_K_pyramid(K, sizes)[level], T, idepth.to(dev))[0]


def k1_step_calls(dev, g):
    """K1's backward calls in one two-view step at the recipe (phase 8), as
    [{"label", "image", "grid", "needs", "calls"}]: the left-right consistency loss samples
    each view's idepth map at every level (``losses/consistency.py:83``, ``:92``; two calls
    a level, C = 1, the map's and the grid's gradients) and the reconstruction loss each
    view's image at 480x640 (``consistency.py:32``; two calls a level, C = 3, the grid's
    gradient only: the images are data). Each at B = 8 on ``loss_grid`` of its level."""
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    calls = []
    for level, (rows, cols) in enumerate(pyramid_sizes(H0, W0, NUM_LEVELS)):
        calls.append({"label": f"({TRAIN_B},{rows},{cols},1) left-right, both gradients",
                      "image": (torch.rand(TRAIN_B, rows, cols, 1, generator=g) * 0.4
                                + 0.1).to(dev),
                      "grid": loss_grid(TRAIN_B, dev, g, level), "needs": (True, True),
                      "calls": 2})
    calls.append({"label": f"({TRAIN_B},{H0},{W0},3) reconstruction, grid gradient only",
                  "image": (torch.rand(TRAIN_B, H0, W0, 3, generator=g) * 2 - 1).to(dev),
                  "grid": loss_grid(TRAIN_B, dev, g), "needs": (False, True),
                  "calls": 2 * NUM_LEVELS})
    return calls


def k1_backward_bytes(image, grid, cot, needs) -> int:
    """The bytes K1's backward must move: the grid and the output's gradient ``cot`` read
    once, the image read once for the grid's gradient, and each gradient asked for
    written once."""
    return (nbytes(grid, cot) + nbytes(image) * (int(needs[0]) + int(needs[1]))
            + nbytes(grid) * int(needs[1]))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(read_write_bytes, flops, peak_flops=PEAK_F32_FLOPS):
    """The least time (ms) the card could take: bytes over its memory rate or operations
    over their type's peak (f32 by default), the larger, and which of the two it is."""
    by_bytes = read_write_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def conv_flops(module, pixels) -> int:
    """2 x multiply-adds of every 3x3 conv of ``module`` over ``pixels`` outputs each."""
    return 2 * pixels * sum(m.weight.numel() for m in module.modules()
                            if isinstance(m, torch.nn.Conv2d))


def timings(kernel, plain):
    """A call (wrapper, host work included) and the device time alone, of kernel and
    plain version."""
    return {"call_ms": median_ms(kernel), "plain_call_ms": median_ms(plain),
            "ms": graph_ms(kernel), "plain_ms": graph_ms(plain)}


def describe(t, b):
    return (f"a call: kernel {t['call_ms']:.4f} ms, plain {t['plain_call_ms']:.4f} ms; "
            f"device: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound "
            f"{b[0]:.4f} ms ({b[1]})")


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the serving shapes, its time
    on the device beside its bound, and (K1) the one PyTorch call that computes it."""
    import torch.nn.functional as F

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        incremental_homographies, normalize_baseline)
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner, IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops import homography_grid
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    g = torch.Generator().manual_seed(0)
    results = {}

    def geometry(n, seed, rows=H0, cols=W0):
        K, T = scene(n, seed)
        T, _ = normalize_baseline(T)
        if (rows, cols) != (H0, W0):
            K = build_K_pyramid(K, [(H0, W0), (rows, cols)])[1]
        sizes = pyramid_sizes(rows, cols, 5)
        K_pyr = build_K_pyramid(K, sizes)
        samples = create_idepth_samples(T, K_pyr[4], *sizes[4], D)
        return K_pyr, T, samples

    def check_warp(image, grid, what, zero=True):
        """K1 vs plain; F.grid_sample on the same data, the NCHW copy made outside the
        timed span, is the one PyTorch call for the same function (less the mask)."""
        got, inv = warp.grid_sample(image, grid, zero_invalid=zero, impl="kernel")
        ref, inv_ref = warp.grid_sample(image, grid, zero_invalid=zero, impl="plain")
        err = (got - ref).abs().max().item()
        t = timings(lambda: warp.grid_sample(image, grid, zero, impl="kernel"),
                    lambda: warp.grid_sample(image, grid, zero, impl="plain"))
        x_nchw = image.permute(0, 3, 1, 2).contiguous()
        grid4 = grid.reshape(grid.shape[0], -1, grid.shape[-2], 2)
        t["library_ms"] = graph_ms(lambda: F.grid_sample(
            x_nchw, grid4, mode="bilinear", padding_mode="border", align_corners=False))
        pixels = got.numel() // image.shape[-1]
        b = bound(nbytes(image, grid, got, inv), pixels * (20 + 7 * image.shape[-1]))
        log(f"K1 grid_sample {what}: max_abs_err {err:.3e} (bar {WARP_BAR:.0e}), invalid "
            f"masks equal {bool(torch.equal(inv, inv_ref))}, invalid share "
            f"{inv.float().mean().item():.4f}; {describe(t, b)}; F.grid_sample device "
            f"{t['library_ms']:.4f} ms")
        if not (err <= WARP_BAR and torch.equal(inv, inv_ref)):
            raise AssertionError(f"K1 disagrees with its plain version at {what}")
        return err, t, b

    # K1 at the min-idepth warp, (1, 480, 640, 3), and at the plane sweep,
    # (5, 30, 40, 3) -> (5, 12, 30, 40, 3); the JSON line keeps the first's times.
    K_pyr, T, samples = geometry(1, 1)
    H_min = create_plane_sweep_homographies(T, K_pyr[0], samples[:, :1])[:, 0]
    image = (torch.rand(1, H0, W0, 3, generator=g) * 2 - 1).to(dev)
    err, t, b = check_warp(image, homography_grid(H_min, H0, W0),
                           "(1,480,640,3) min-idepth warp")
    results["warp"] = {"max_abs_err": err, **t, "bound_ms": b[0], "bound_by": b[1]}
    K_pyr, T, samples = geometry(5, 2)
    grid = homography_grid(create_plane_sweep_homographies(T, K_pyr[4], samples), 30, 40)
    image4 = (torch.rand(5, 30, 40, 3, generator=g) * 2 - 1).to(dev)
    err, _, _ = check_warp(image4, grid, "(5,30,40,3)->(5,12,30,40,3) plane sweep")
    results["warp"]["max_abs_err"] = max(results["warp"]["max_abs_err"], err)

    # K1 where the two-view losses call it (phase 8): the grid projected from a B = 8
    # 480x640 idepth map, sampling one channel (idepth maps, occlusion masks) and three
    # (the reconstruction's right image). Each shape's times go into "loss_shapes".
    grid = loss_grid(TRAIN_B, dev, g)
    results["warp"]["loss_shapes"] = []
    for C, what in ((1, "idepth and occlusion samples"), (3, "reconstruction")):
        image = (torch.rand(TRAIN_B, H0, W0, C, generator=g) * 2 - 1).to(dev)
        err, t, b = check_warp(image, grid, f"({TRAIN_B},{H0},{W0},{C}) {what}", zero=False)
        results["warp"]["loss_shapes"].append({"shape": [TRAIN_B, H0, W0, C],
                                               "max_abs_err": err, **t, "bound_ms": b[0],
                                               "bound_by": b[1]})
        results["warp"]["max_abs_err"] = max(results["warp"]["max_abs_err"], err)

    # A NaN coordinate gives NaN in every channel where the plain version does (and
    # the JAX gather), +-inf clamps to the border; the flags and all else agree bit for bit.
    bad = grid.clone()
    bad[0, :4, :8, 0] = float("nan")
    bad[1, 5, :8, 1] = float("nan")
    bad[2, 7, :4] = float("nan")
    bad[3, 9, :4, 0], bad[3, 9, 4:8, 1] = float("inf"), -float("inf")
    bad[4, 11, :4, 0], bad[4, 11, :4, 1] = float("nan"), 5.0
    for C in (1, 3):
        image = (torch.rand(TRAIN_B, H0, W0, C, generator=g) * 2 - 1).to(dev)
        for zero_invalid in (False, True):
            got, inv = warp.grid_sample(image, bad, zero_invalid, impl="kernel")
            ref, inv_ref = warp.grid_sample(image, bad, zero_invalid, impl="plain")
            nan_equal = torch.equal(torch.isnan(got), torch.isnan(ref))
            rest_equal = torch.equal(torch.nan_to_num(got, nan=7.0),
                                     torch.nan_to_num(ref, nan=7.0))
            log(f"K1 NaN grid C={C} zero_invalid={zero_invalid}: NaN outputs "
                f"{int(torch.isnan(got).sum())} (plain {int(torch.isnan(ref).sum())}), "
                f"at the same places {nan_equal}; invalid flags equal "
                f"{torch.equal(inv, inv_ref)}; all else bit-equal {rest_equal}")
            if not (nan_equal and rest_equal and torch.equal(inv, inv_ref)
                    and bool(torch.isnan(ref).any())):
                raise AssertionError("K1 disagrees with its plain version at a NaN grid")

    # K2 at N = B*V = 1, 5 and 8, 30x40x32, D = 12, seeded fan-in-scale refiner; the
    # device time also with each cluster size forced. The JSON line keeps N = 1.
    refiner = FeatureRefiner(32)
    prefix = "right_feature_extractor.refiner."
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev).eval()
    for n in (1, 5, 8):
        K_pyr, T, samples = geometry(n, 10 + n)
        H_inc = incremental_homographies(
            create_plane_sweep_homographies(T, K_pyr[4], samples))
        feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev)
        image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)

        def kernel(cluster=0):
            return chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc, cluster)

        def plain():
            return chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="plain")
        got, ref = kernel(), plain()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=CHAIN_ATOL * scale, rtol=CHAIN_RTOL)
        t = timings(kernel, plain) if n == 1 else {"ms": graph_ms(kernel)}
        forced = {c: graph_ms(lambda: kernel(c)) for c in (16, 8)}
        b = bound(nbytes(feats0, image_rest, H_inc, got, *refiner.parameters()),
                  (D - 1) * (conv_flops(refiner, n * 30 * 40) + 20 * got[:, 0].numel()))
        detail = describe(t, b) if n == 1 else f"device {t['ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]})"
        log(f"K2 incremental_chain N={n} 30x40x32 D={D}: max_abs_err {err:.3e}, max|plain| "
            f"{scale:.3f} (bar atol {CHAIN_ATOL:.0e}*max|plain| + rtol {CHAIN_RTOL:.0e}), "
            f"within bar {ok}; cluster {chain.cluster_size(n, 30, 40)} blocks a sample; "
            f"{detail}; device with 16-block clusters {forced[16]:.4f} ms, with 8 "
            f"{forced[8]:.4f} ms")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at N={n}")
        if n == 1:
            results["chain"] = {"max_abs_err": err, **t, "bound_ms": b[0], "bound_by": b[1],
                                "library_ms": None}
        else:
            results["chain"]["max_abs_err"] = max(results["chain"]["max_abs_err"], err)

    # K2 at the convergence recipe's level 4 (phase 15: 96x128, B = 4): N = 4, 6x8x32,
    # where a sample's cluster has more blocks than the map has rows.
    h4, w4 = CONV_SIZE[0] // 16, CONV_SIZE[1] // 16
    n = CONV_B
    K_pyr, T, samples = geometry(n, 30, *CONV_SIZE)
    H_inc = incremental_homographies(create_plane_sweep_homographies(T, K_pyr[4], samples))
    feats0 = torch.randn(n, h4, w4, 32, generator=g).to(dev)
    image_rest = (torch.rand(n, D - 1, h4, w4, 3, generator=g) * 2 - 1).to(dev)
    ref = chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="plain")
    scale = ref.abs().max().item()
    for c in (0, 16, 8):
        got = chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc, c)
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=CHAIN_ATOL * scale, rtol=CHAIN_RTOL)
        log(f"K2 incremental_chain N={n} {h4}x{w4}x32 D={D}, cluster "
            f"{c or chain.cluster_size(n, h4, w4)} blocks a sample"
            f"{' (chosen)' if c == 0 else ' (forced)'}: max_abs_err {err:.3e}, max|plain| "
            f"{scale:.3f}, within bar {ok}")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at N={n} {h4}x{w4}")
        results["chain"]["max_abs_err"] = max(results["chain"]["max_abs_err"], err)

    # K3 at the refiners of level 4 (N = B*V = 1, 2, 5 and 8: the B=1 V=1, V=2, V=5 and
    # B=8 cells) and level 3 (N = 1); the JSON line keeps the level-3 times, where it
    # does the most work.
    state = random_state_dict(4)
    results["refiner"] = {"max_abs_err": 0.0, "library_ms": None}
    for n, h, w, name in ((1, 30, 40, "refiner4"), (2, 30, 40, "refiner4"),
                          (5, 30, 40, "refiner4"), (8, 30, 40, "refiner4"),
                          (1, 60, 80, "refiner3")):
        with torch.inference_mode(False):  # parameters with version counters, as served
            module = IDepthmapRefiner(35)
            module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                    if k.startswith(name + ".")})
            module = module.to(dev).eval()
        guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev)
        idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
        got = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="kernel")
        ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=CHAIN_ATOL * scale, rtol=CHAIN_RTOL)
        t = timings(lambda: refiner_op.idepthmap_refiner(module, guidance, idepth,
                                                         impl="kernel"),
                    lambda: refiner_op.idepthmap_refiner(module, guidance, idepth,
                                                         impl="plain"))
        b = bound(nbytes(guidance, idepth, got, *module.parameters()),
                  conv_flops(module, n * h * w) + 7 * 10 * 32 * n * h * w)
        log(f"K3 idepthmap_refiner ({n},35,{h},{w}): max_abs_err {err:.3e}, max|plain| "
            f"{scale:.3f} (bar atol {CHAIN_ATOL:.0e}*max|plain| + rtol {CHAIN_RTOL:.0e}), "
            f"within bar {ok}; {describe(t, b)}")
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version at ({n},35,{h},{w})")
        results["refiner"].update(max_abs_err=max(results["refiner"]["max_abs_err"], err),
                                  **t, bound_ms=b[0], bound_by=b[1])

    # K3 at the convergence recipe's levels 4-1 (96x128, n = B = 4), where
    # ``fused_refiner_supported`` takes four refiners: maps of 6x8 up to 48x64.
    for lvl in (4, 3, 2, 1):
        h, w = CONV_SIZE[0] >> lvl, CONV_SIZE[1] >> lvl
        name = f"refiner{lvl}"
        with torch.inference_mode(False):
            module = IDepthmapRefiner(35)
            module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                    if k.startswith(name + ".")})
            module = module.to(dev).eval()
        guidance = (torch.rand(CONV_B, 35, h, w, generator=g) * 2 - 1).to(dev)
        idepth = (torch.rand(CONV_B, h, w, generator=g) * 20).to(dev)
        got = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="kernel")
        ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=CHAIN_ATOL * scale, rtol=CHAIN_RTOL)
        device_kernel = graph_ms(lambda: refiner_op.idepthmap_refiner(
            module, guidance, idepth, impl="kernel"))
        log(f"K3 idepthmap_refiner ({CONV_B},35,{h},{w}) ({name} at "
            f"{CONV_SIZE[0]}x{CONV_SIZE[1]}): max_abs_err {err:.3e}, max|plain| {scale:.3f}, "
            f"within bar {ok}; device: kernel {device_kernel:.4f} ms")
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version at ({CONV_B},35,{h},{w})")
        results["refiner"]["max_abs_err"] = max(results["refiner"]["max_abs_err"], err)

    # K4 at every GroupNorm shape of the serving forward and of phase 15's step, held against
    # the plain version, with its device time beside the bound. The JSON line keeps the
    # 480x640 resblock's times.
    weight = state["refiner0.res0.bn1.weight"].to(dev)
    bias = state["refiner0.res0.bn1.bias"].to(dev)
    results["gn_apply"] = {"max_abs_err": 0.0, "library_ms": None, "shapes": []}
    sms = gn_apply.sm_count(dev)
    for shape, residual, what in GN_SHAPES + CONV_GN_SHAPES:
        x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev)
        res = torch.randn(shape, generator=g).to(dev) if residual else None

        def kernel():
            return gn_apply.group_norm_act(x, weight, bias, 4, res, impl="kernel")

        def plain():
            return gn_apply.group_norm_act(x, weight, bias, 4, res, impl="plain")
        ref = plain()
        tol = GN_BAR * max(1.0, ref.abs().max().item())
        got = kernel()
        err = (got - ref).abs().max().item()
        t = timings(kernel, plain)
        p = gn_apply.plan(shape, 4, x.dtype, sms)
        b = bound(nbytes(x, got, weight, bias, *([res] if residual else [])), 10 * x.numel())
        log(f"K4 group_norm_act {shape} {'+ res' if residual else 'no res'} ({what}): "
            f"max_abs_err {err:.3e} (bar {tol:.3e}); {p.blocks} chunks a row; "
            f"{describe(t, b)}")
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K4 disagrees with its plain version at {shape}")
        results["gn_apply"]["max_abs_err"] = max(results["gn_apply"]["max_abs_err"], err)
        results["gn_apply"]["shapes"].append(
            {"shape": list(shape), "residual": residual, "chunks": p.blocks, "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": b[0]})
        if shape == (1, 32, H0, W0) and residual:
            results["gn_apply"].update(**t, bound_ms=b[0], bound_by=b[1])

    # K4 at the recipe's B = 8 shapes (phase 7's step), f32 and bf16 (the conv's bias as
    # xbias): against the plain version (f32 within GN_BAR, bf16 within phase 11's bar),
    # with its device time beside the bound.
    xbias = state["refiner0.res0.conv1.bias"].to(dev)
    results["gn_apply"]["recipe_shapes"] = []
    for shape, residual, what in RECIPE_GN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev).to(dtype)
            res = torch.randn(shape, generator=g).to(dev).to(dtype) if residual else None
            xb = xbias if dtype == torch.bfloat16 else None
            ref = gn_apply.group_norm_act(x, weight, bias, 4, res, "plain", xb)

            def run():
                return gn_apply.group_norm_act(x, weight, bias, 4, res, "kernel", xb)
            got = run()
            if dtype == torch.float32:
                err = (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())
                ok = err <= GN_BAR
            else:
                err = gn_bf16_ulps(got, ref, x, weight, bias, xb)
                ok = err <= 1.0
            if not (ok and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K4 disagrees with its plain version at {shape} {dtype}")
            b = bound(nbytes(x, got, weight, bias, *([res] if residual else [])),
                      10 * x.numel())
            row = {"shape": list(shape), "residual": residual, "dtype": str(dtype)[6:],
                   "err": err, "ms": graph_ms(run), "bound_ms": b[0]}
            unit = ("of max(1, max|plain|), bar 1e-5" if dtype == torch.float32
                    else "of the bf16 bar")
            log(f"K4 group_norm_act recipe {shape} {'+ res' if residual else 'no res'} "
                f"{row['dtype']} ({what}): device {row['ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({b[1]}); error {err:.3e} ({unit})")
            results["gn_apply"]["recipe_shapes"].append(row)
    return results


def gn_bf16_ulps(got, ref, x, weight, bias, xbias):
    """K4's worst element at bf16 in units of phase 11's bar: one bf16 ulp of the f32
    GroupNorm value, one of the plain result and GN_F32_FLOOR of |x_hat gamma| + |beta|."""
    F = torch.nn.functional
    channel = (1, -1) + (1,) * (x.ndim - 2)
    x32 = x.float() + xbias.reshape(channel)
    y = F.group_norm(x32, 4, weight, bias, 1e-5)
    terms = ((F.group_norm(x32, 4, eps=1e-5) * weight.reshape(channel)).abs()
             + bias.abs().reshape(channel))
    ref = ref.float()
    bar = bf16_ulp(y) + bf16_ulp(ref) + GN_F32_FLOOR * terms
    return ((got.float() - ref).abs() / bar).max().item()


def check_backward(dev, dtype=torch.float32):
    """Phase 3b: each kernel's backward (its Function: K1's, K2's and K4's backward
    kernels, K3's recompute) against plain autograd at phase 3's shapes, with its device
    time, the plain path's and (K1, K4) the library's; the backward kernels alone against
    their closed forms (``alone``). Returns {kernel: backward entry}. With ``dtype``
    bf16 (phase 12 (a)) each kernel takes its bf16 inputs as the bf16 forward gives them
    (K1 an f32 image and grid, bf16 out; K2 bf16 feats0; K3 bf16 guidance, f32 idepth;
    K4 bf16 x and res and the conv's bias as an f32 xbias), every gradient must come back
    at its input's dtype, and the two backwards are compared with cuDNN and PyTorch
    deterministic (a bf16 scatter-add's order moves its result by whole bf16 ulps); the
    losses' K1 stays f32 at bf16 training and is not run again."""
    import torch.nn.functional as F

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        incremental_homographies, normalize_baseline)
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner
    from multi_view_stereonet_tpu_torch.ops import homography_grid
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    g = torch.Generator().manual_seed(1)
    results = {}
    bf16 = dtype == torch.bfloat16
    tag = " bf16" if bf16 else ""

    def geometry(n, seed):
        K, T = scene(n, seed)
        T, _ = normalize_baseline(T)
        K_pyr = build_K_pyramid(K, pyramid_sizes(H0, W0, 5))
        return K_pyr, T, create_idepth_samples(T, K_pyr[4], 30, 40, D)

    def leaf(x):
        return x.to(dev).requires_grad_()

    def check(key, what, run, inputs, library=None, keep=False, cot_mask=None, legs=None):
        """run(impl) -> output; library() -> (output, inputs) of the one PyTorch call.
        The JSON line keeps the times of the shape checked with ``keep``. The output's
        gradient is 0 where ``cot_mask`` is False. ``legs(cot, got, ref)``, where given
        (K2), holds the Function to plain autograd by ``chain_legs``' bars, in place of
        the direct bar."""
        outs = {impl: run(impl) for impl in ("kernel", "plain")}
        cot = torch.randn(outs["plain"].shape, generator=g).to(dev, outs["plain"].dtype)
        if cot_mask is not None:
            cot = cot * cot_mask

        def backward(impl):
            return torch.autograd.grad(outs[impl], inputs, cot, retain_graph=True)
        before, bwd_before = read_launches(), backward_launches()
        with deterministic(bf16):
            got, ref = backward("kernel"), backward("plain")
            torch.cuda.synchronize()
        if read_launches() != before:
            raise AssertionError(f"{key}{tag} {what}: the backward launched a forward kernel")
        bwd = {k: v - bwd_before[k] for k, v in backward_launches().items()}
        want = {k: BACKWARD_PER[k] * int(BACKWARD_OF.get(key.split()[0]) == k)
                for k in BACKWARD_KERNELS}
        if bwd != want:
            raise AssertionError(f"{key}{tag} {what}: backward launches {bwd}, expected "
                                 f"{want}")
        dtypes = [t.dtype for t in got]
        if dtypes != [t.dtype for t in inputs] or outs["kernel"].dtype != outs["plain"].dtype:
            raise AssertionError(f"{key}{tag} {what}: output {outs['kernel'].dtype}, "
                                 f"gradients {dtypes} for inputs "
                                 f"{[t.dtype for t in inputs]}")
        err = worst_relative(got, ref)
        split = None if legs is None else legs(cot, got, ref)
        entry = {"max_rel_err": err,
                 "ms": device_ms(lambda: backward("kernel"), BACKWARD_REPS, 1),
                 "plain_ms": device_ms(lambda: backward("plain"), BACKWARD_REPS, 1),
                 "library_ms": None}
        if library is not None:
            lib_out, lib_inputs = library()
            lib_cot = torch.randn(lib_out.shape, generator=g).to(dev)
            entry["library_ms"] = device_ms(lambda: torch.autograd.grad(
                lib_out, lib_inputs, lib_cot, retain_graph=True), BACKWARD_REPS, 1)
        lib = ("" if entry["library_ms"] is None
                else f", library {entry['library_ms']:.4f} ms")
        # K4's backward kernel at bf16 rounds its own f32 dx to bf16, where plain autograd
        # rounds F.group_norm's: phase 12's flat-gradient bar, and the worst element's
        # bf16 ulps beside it.
        bar = BF16_TRAIN_GRAD_BAR if bf16 and key == "K4" else BACKWARD_BAR
        ulps = max([((a.float() - r.float()).abs() / bf16_ulp(r.float())).max().item()
                    for a, r in zip(got, ref) if r.dtype == torch.bfloat16], default=0.0)
        entry["worst_bf16_ulps"] = ulps
        legs_note = ""
        if split is not None:
            entry["legs"] = split
            legs_note = "; " + describe_legs(split)
        log(f"{key}{tag} backward {what}: worst gradient error {err:.3e} of max|plain| "
            f"({'see the legs' if split else f'bar {bar:.0e}'})"
            f"{f', worst bf16 element {ulps:.2f} ulps' if bf16 else ''}{legs_note}; "
            f"gradients {[str(d)[6:] for d in dtypes]}; backward launches {bwd}; device: "
            f"through the kernel's Function {entry['ms']:.4f} ms, plain path "
            f"{entry['plain_ms']:.4f} ms{lib}")
        ok = not split["missed"] if split is not None else err <= bar
        if not ok:
            raise AssertionError(f"{key}{tag} backward disagrees with plain autograd at "
                                 f"{what}")
        old = results.get(key)
        if old is not None:
            base = entry if keep else old
            results[key] = {**base, "max_rel_err": max(old["max_rel_err"], err)}
        else:
            results[key] = entry

    def alone(key, label, run_kernel, run_plain, read_write, flops, keep,
              peak=PEAK_F32_FLOPS, part="kernel", clocks=(graph_ms, graph_ms)):
        """A backward kernel alone (K1, K2, K3; both launches of K2's and K3's) against its
        plain version in closed form on the same inputs (K2, K3: what its forward kept),
        within phase 3b's bar (at bf16, K2: the flat-gradient bar of phase 12, as K4's; K3:
        K3_BF16_BAR), with both device times (CUDA graphs) and the bound, its operations at
        ``peak``; ``part`` "wgrad": K2's or K3's weight-gradient pass alone against its
        plain version on the maps the sequential part kept, by the same bar. ``clocks``
        time the kernel and the plain version (K2's: no CUDA graph, see ``k2_section``).
        The JSON line keeps the shape checked with ``keep``."""
        def flat(grads):
            return [t for g in grads for t in (g if isinstance(g, tuple) else (g,))]
        with torch.no_grad():
            got, ref = flat(run_kernel()), flat(run_plain())
            torch.cuda.synchronize()
            pairs = [(a, r) for a, r in zip(got, ref) if r is not None]
            err = worst_relative(*zip(*pairs))
            abs_err = max((a.float() - r.float()).abs().max().item() for a, r in pairs)
            t = {"ms": clocks[0](run_kernel), "plain_ms": clocks[1](run_plain)}
        b = bound(read_write, flops, peak)
        bar = {"K2": BF16_TRAIN_GRAD_BAR, "K3": K3_BF16_BAR}.get(key, BACKWARD_BAR) if bf16 \
            else BACKWARD_BAR
        log(f"{key}{tag} backward {part} {label}: against its plain version {err:.3e} of "
            f"max|plain| (bar {bar:.0e}), max_abs_err {abs_err:.3e}; device: kernel "
            f"{t['ms']:.4f} ms, plain version {t['plain_ms']:.4f} ms, bound {b[0]:.4f} ms "
            f"({b[1]})")
        if not err <= bar:
            raise AssertionError(f"{key}{tag} backward {part} disagrees with its plain "
                                 f"version at {label}")
        entry = {"max_rel_err": err, "max_abs_err": abs_err, **t, "bound_ms": b[0],
                 "bound_by": b[1], "bar": bar}
        old = results.get(f"{key} {part}")
        if old is None or keep:
            entry["shapes"] = (old or {}).get("shapes", [])
            results[f"{key} {part}"] = entry
            old = entry
        old["max_rel_err"] = max(old["max_rel_err"], err)
        old["max_abs_err"] = max(old["max_abs_err"], abs_err)
        old["shapes"].append({"shape": label, "ms": t["ms"], "plain_ms": t["plain_ms"],
                              "bound_ms": b[0], "max_rel_err": err})

    def k1_alone(image, grid, zero_invalid, what, keep=False, library=None):
        image, grid = image.detach(), grid.detach()
        cot = torch.randn(grid.shape[:-1] + image.shape[-1:], generator=g).to(dev, dtype)
        M, C = grid[..., 0].numel(), image.shape[-1]
        alone("K1", what, lambda: warp.grid_sample_backward(image, grid, cot, zero_invalid),
              lambda: warp.grid_sample_backward_plain(image, grid, cot, zero_invalid),
              k1_backward_bytes(image, grid, cot, (True, True)), M * (30 + 24 * C), keep)
        if keep and library is not None:
            results["K1 kernel"]["library_ms"] = library

    # K1 at the min-idepth warp (the JSON keeps its times) and the plane sweep.
    for n, rows, cols, grid_of, what in (
            (1, H0, W0, lambda K_pyr, T, s: homography_grid(
                create_plane_sweep_homographies(T, K_pyr[0], s[:, :1])[:, 0], H0, W0),
             "(1,480,640,3) min-idepth warp"),
            (5, 30, 40, lambda K_pyr, T, s: homography_grid(
                create_plane_sweep_homographies(T, K_pyr[4], s), 30, 40),
             "(5,30,40,3)->(5,12,30,40,3) plane sweep")):
        image = leaf(torch.rand(n, rows, cols, 3, generator=g) * 2 - 1)
        grid = leaf(grid_of(*geometry(n, n)))

        def library(image=image, grid=grid):
            x = image.detach().permute(0, 3, 1, 2).contiguous().requires_grad_()
            grid4 = grid.detach().reshape(n, -1, grid.shape[-2], 2).requires_grad_()
            return F.grid_sample(x, grid4, mode="bilinear", padding_mode="border",
                                 align_corners=False).to(dtype), (x, grid4)
        check("K1", what, lambda impl: warp.grid_sample(image, grid, True, impl,
                                                        out_dtype=dtype)[0],
              (image, grid), library, keep=n == 1)
        k1_alone(image, grid, True, what, keep=n == 1, library=results["K1"]["library_ms"])

    # K1 where the two-view losses call it: one channel and three at 480x640, B = 8, the
    # grid projected from idepth; image and grid both leaves.
    grid0 = loss_grid(TRAIN_B, dev, g)
    for C in () if bf16 else (1, 3):
        image = leaf(torch.rand(TRAIN_B, H0, W0, C, generator=g) * 2 - 1)
        grid = grid0.detach().clone().requires_grad_()

        def library(image=image, grid=grid):
            x = image.detach().permute(0, 3, 1, 2).contiguous().requires_grad_()
            grid4 = grid.detach().clone().requires_grad_()
            return F.grid_sample(x, grid4, mode="bilinear", padding_mode="border",
                                 align_corners=False), (x, grid4)
        check(f"K1 C={C}", f"({TRAIN_B},{H0},{W0},{C}) loss samples, image and grid leaves",
              lambda impl: warp.grid_sample(image, grid, False, impl)[0], (image, grid),
              library)
        k1_alone(image, grid, False, f"({TRAIN_B},{H0},{W0},{C}) loss samples")

    # K1's backward at a two-view step's 20 calls (``k1_step_calls``), each with its
    # gradients: the kernel alone against its closed form (``alone``), beside its bound and
    # F.grid_sample's autograd for the same gradients on the same data; and the sums a step.
    # Its inputs come from a generator of their own, so that the sections below draw theirs
    # as before.
    if not bf16:
        g_step = torch.Generator().manual_seed(21)
        for c in k1_step_calls(dev, g_step):
            image, grid, needs = c["image"], c["grid"], c["needs"]
            cot = torch.randn(grid.shape[:-1] + image.shape[-1:], generator=g_step).to(dev)
            alone("K1", c["label"], lambda a=(image, grid, cot, False, needs):
                  warp.grid_sample_backward(*a),
                  lambda a=(image, grid, cot, False, needs):
                  warp.grid_sample_backward_plain(*a),
                  k1_backward_bytes(image, grid, cot, needs),
                  grid[..., 0].numel() * (30 + 24 * image.shape[-1]), False, part="step")
            x = image.permute(0, 3, 1, 2).contiguous().requires_grad_(needs[0])
            grid4 = grid.clone().requires_grad_(needs[1])
            call = results["K1 step"]["shapes"][-1]
            call.update(needs=list(needs), calls=c["calls"],
                        library_ms=backward_graph_ms(
                            lambda x=x, grid4=grid4: F.grid_sample(
                                x, grid4, mode="bilinear", padding_mode="border",
                                align_corners=False),
                            [t for t, need in zip((x, grid4), needs) if need]))
            log(f"K1 backward step call {c['label']} x{c['calls']}: device {call['ms']:.4f} "
                f"ms, bound {call['bound_ms']:.4f} ms, F.grid_sample autograd "
                f"{call['library_ms']:.4f} ms")
        step = results["K1 step"]
        for key in ("ms", "bound_ms", "library_ms"):
            step[f"step_{key}"] = sum(c["calls"] * c[key] for c in step["shapes"])
        log(f"K1 backward, a two-view step's {sum(c['calls'] for c in step['shapes'])} "
            f"calls: device {step['step_ms']:.4f} ms, bound {step['step_bound_ms']:.4f} ms, "
            f"F.grid_sample autograd {step['step_library_ms']:.4f} ms")

    def k2_section():
        """K2 at N = 1 (the JSON keeps it) and N = 8, the training recipe's B*V: its
        Function against plain autograd at both, then its backward alone against its closed
        form and its weight-gradient pass against its plain version. Last in the phase, its
        kernels timed by ``queued_ms`` and its plain versions by torch.profiler: CUDA graphs
        of K2's backward or of its closed form at bf16 were seen, in three runs of four, to
        stop torch.profiler's device events for the rest of the process."""
        def profiled(fn):
            return device_ms(fn, BACKWARD_REPS, 1)
        refiner = FeatureRefiner(32)
        prefix = "right_feature_extractor.refiner."
        refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                                 if k.startswith(prefix)})
        refiner = refiner.to(dev)
        params = list(refiner.parameters())
        cases = []
        for n in (1, 8):
            K_pyr, T, samples = geometry(n, 10 + n)
            H_inc = incremental_homographies(create_plane_sweep_homographies(
                T, K_pyr[4], samples))
            feats0 = leaf(torch.randn(n, 30, 40, 32, generator=g).to(dtype))
            image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)

            def legs(cot, got, ref, feats0=feats0, image_rest=image_rest, H_inc=H_inc):
                return chain_legs(refiner, feats0, image_rest, H_inc, cot, got, ref)
            check("K2", f"N={n} 30x40x32 D={D}",
                  lambda impl: chain.incremental_chain(refiner, feats0, image_rest, H_inc,
                                                       impl),
                  (feats0, *params), keep=n == 1, legs=legs)
            cases.append((n, feats0, image_rest, H_inc))
        for n, feats0, image_rest, H_inc in cases:
            what = f"N={n} 30x40x32 D={D}"
            # The backward alone (both launches), on what the forward kept: every gradient
            # against the closed form (image_rest's and H_inc's too); timed for what the
            # recipe asks (feats0 and the weights). Its convs' operations at bf16 storage at
            # the bf16 peak (the dgrads run on bf16 mma.sync; the weight gradients' bf16
            # operands on TF32 mma.sync, exact for them, at half that peak).
            with torch.no_grad():
                f0, im = feats0.detach(), image_rest.to(dtype)
                weights = chain._weight_args(refiner)
                out, raw, stats = chain._forward_launch(f0, im, H_inc, *weights, 0, False,
                                                        True)
                cot = torch.randn(out.shape, generator=g).to(dev, dtype)
            flops = (D - 1) * (conv_flops(refiner, n * 30 * 40)
                               + 2 * n * 30 * 40 * 32 * 288 * 3)
            alone("K2", what,
                  lambda: chain._launch_backward(refiner, im, H_inc, weights, out, raw, stats,
                                                 cot, (True, True, True), 0, False),
                  lambda: chain.incremental_chain_backward_plain(
                      refiner, f0, im, H_inc, out, raw, stats, cot, (True, True, True, True)),
                  nbytes(out, raw, stats, cot, im, H_inc, *weights, f0, *params), flops,
                  keep=n == 1, peak=PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS,
                  clocks=(queued_ms, profiled))
            entry = results["K2 kernel"]["shapes"][-1]
            entry["recipe_ms"] = queued_ms(lambda: chain._launch_backward(
                refiner, im, H_inc, weights, out, raw, stats, cot, (True, False, False), 0,
                False))
            log(f"K2{tag} backward kernel {what}, feats0's and the weights' gradients alone "
                f"(the recipe's): device {entry['recipe_ms']:.4f} ms")
            # The weight-gradient pass alone on the maps the sequential part kept; its
            # products are the forward's convs' multiply-adds over every step.
            with torch.no_grad():
                seq = chain.incremental_chain_sequential(im, H_inc, *weights, out, raw, stats,
                                                         cot, (True, False, False), 0, False)
            alone("K2", what,
                  lambda: chain._param_grads(refiner, chain.incremental_chain_wgrad(
                      im, H_inc, weights[3], out, raw, stats, *seq[3:])),
                  lambda: chain.incremental_chain_wgrad_plain(refiner, im, H_inc, out, raw,
                                                              stats, *seq[3:5], seq[5].sum(0)),
                  nbytes(im, H_inc, weights[3], out, raw, stats, *seq[3:], *params),
                  (D - 1) * conv_flops(refiner, n * 30 * 40), keep=n == 1,
                  peak=PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS, part="wgrad",
                  clocks=(queued_ms, profiled))

    # K3 at level 4 (N = 1, 8) and level 3 (N = 1, the JSON keeps it; N = 8, the recipe's):
    # its Function against plain autograd by ``refiner_legs``, the backward kernel alone
    # against its closed form on what the forward kept, and the recompute it replaced (the
    # plain forward under autograd, then its backward) timed beside it.
    state = random_state_dict(4)
    for n, h, w, name in ((1, 30, 40, "refiner4"), (8, 30, 40, "refiner4"),
                          (1, 60, 80, "refiner3"), (8, 60, 80, "refiner3")):
        module = refiner_module(state, name, dev)
        params = list(module.parameters())
        guidance = leaf((torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dtype))
        idepth = leaf(torch.rand(n, h, w, generator=g) * 20)
        what, keep = f"({n},35,{h},{w})", (n, h) == (1, 60)

        def legs(cot, got, ref, module=module, guidance=guidance, idepth=idepth):
            return refiner_legs(module, guidance, idepth, cot, got, ref)
        check("K3", what,
              lambda impl: refiner_op.idepthmap_refiner(module, guidance, idepth, impl),
              (guidance, idepth, *params), keep=keep, legs=legs)
        g0, i0 = guidance.detach(), idepth.detach()
        cot = torch.randn(n, h, w, generator=g).to(dev)

        def recompute(module=module, g0=g0, i0=i0, cot=cot):
            leaves = [g0.clone().requires_grad_(), i0.clone().requires_grad_()]
            out = refiner_op.idepthmap_refiner_plain(module, *leaves)
            return torch.autograd.grad(out, leaves + list(module.parameters()), cot)
        with torch.no_grad():
            out, saved = refiner_op._launch(module, g0, i0, False, keep=True)
        needs = (True, True, True)

        def backward(module=module, g0=g0, i0=i0, out=out, saved=saved, cot=cot):
            return refiner_op._launch_backward(module, g0, i0, out, saved, cot, needs, False)
        alone("K3", what, backward,
              lambda: refiner_op.idepthmap_refiner_backward_plain(module, g0, i0, out,
                                                                  *saved[:2], cot, needs),
              2 * nbytes(g0, i0, *params) + nbytes(out, *saved[:3], cot),
              2 * conv_flops(module, n * h * w), keep,
              peak=PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
        # A second run gives the same bits: no float atomics in either launch.
        with torch.no_grad():
            first, second = backward(), backward()
        same = all(torch.equal(a, b) for a, b in zip(
            [first[0], first[1], *first[2]], [second[0], second[1], *second[2]]))
        log(f"K3{tag} backward {what}: a second run bit-equal to the first: {same}")
        if not same:
            raise AssertionError(f"K3{tag} backward at {what}: two runs differ")
        # The weight-gradient pass alone on the maps the sequential part kept; its products
        # are the forward's convs' multiply-adds.
        dil = refiner_op._dilations(module)
        raw, stats, hs, pack = saved
        with torch.no_grad():
            seq = refiner_op.idepthmap_refiner_sequential(g0, i0, pack, dil, out, raw, stats,
                                                          hs, cot, True, False)
        alone("K3", what,
              lambda: refiner_op._unpack_grads(module, refiner_op.idepthmap_refiner_wgrad(
                  g0, i0, dil, hs, *seq[2:])),
              lambda: refiner_op.idepthmap_refiner_wgrad_plain(
                  module, g0, i0, raw, stats, seq[2], seq[3], seq[4].sum(0).float()),
              nbytes(g0, i0, hs, *seq[2:], *params), conv_flops(module, n * h * w), keep,
              peak=PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS, part="wgrad")
        # The recompute on both clocks, CUDA graph (``graph_ms``, the clock of the kernel's
        # "ms") and torch.profiler (``device_ms``, the clock of ``check``'s Function time),
        # and at the kept shape the device events of one launch by name: torch.profiler
        # records the backward kernel in about one launch of two, so its Function
        # time reads about half the kernel's.
        entry = results["K3 kernel"]["shapes"][-1]
        entry.update(recompute_ms=graph_ms(recompute),
                     recompute_profiled_ms=device_ms(recompute, BACKWARD_REPS, 1))
        if keep:
            with torch.no_grad():
                events = kernel_events(profile_kernels(backward, 1)[2])
            log(f"K3{tag} backward {what}, one launch's device events under torch.profiler: "
                f"{'; '.join(f'{k} {v:.4f}' for k, v in events) or 'none'}")
        log(f"K3{tag} backward {what}: the backward kernel's launch {entry['ms']:.4f} ms by "
            f"CUDA graph; the recompute it replaced (plain forward under autograd, then its "
            f"backward) {entry['recompute_ms']:.4f} ms by CUDA graph, "
            f"{entry['recompute_profiled_ms']:.4f} ms by torch.profiler")
        if keep:
            results["K3 kernel"]["recompute_ms"] = entry["recompute_ms"]
            results["K3"].update(bound_ms=results["K3 kernel"]["bound_ms"],
                                 bound_by=results["K3 kernel"]["bound_by"])

    # K4 at every GroupNorm shape of the serving forward; the JSON keeps the 480x640
    # resblock's times. Its Function (the forward kernel, which also writes the statistics,
    # then the backward kernel) against plain autograd, the output's gradient 0 at the
    # elements next to LeakyReLU's kink (``gn_kink_mask``). The backward kernel alone
    # against its plain version (closed form) on the same statistics and gradient, and
    # the device time of each (CUDA graphs).
    weight = leaf(state["refiner0.res0.bn1.weight"].clone())
    bias = leaf(state["refiner0.res0.bn1.bias"].clone())
    xbias = leaf(state["refiner0.res0.conv1.bias"].clone()) if bf16 else None
    sms = gn_apply.sm_count(dev)
    for shape, residual, what in GN_SHAPES:
        x = leaf((torch.randn(shape, generator=g) * 2 + 0.5).to(dtype))
        res = leaf(torch.randn(shape, generator=g).to(dtype)) if residual else None

        def library(x=x, res=res):
            # The one library GroupNorm at x's dtype (its statistics in f32), no xbias.
            xs = x.detach().requires_grad_()
            rs = None if res is None else res.detach().requires_grad_()
            out = F.leaky_relu(F.group_norm(xs, 4, weight.to(dtype), bias.to(dtype), 1e-5),
                               0.2)
            return (out if rs is None else out + rs), tuple(t for t in (xs, weight, bias, rs)
                                                           if t is not None)

        def run(impl, x=x, res=res):
            return gn_apply.group_norm_act(x, weight, bias, 4, res, impl, xbias)
        keep = shape == (1, 32, H0, W0) and residual
        label = f"{shape} {'+ res' if residual else 'no res'} ({what})"
        operands = tuple(t for t in (x, weight, bias, res, xbias) if t is not None)
        away = gn_kink_mask(x, weight, bias, xbias)
        kink = away.numel() - int(away.sum())
        log(f"K4{tag} {label}: {kink} of {away.numel()} elements within a rounding of "
            f"LeakyReLU's kink, left out of the backward's comparison (cap "
            f"{KINK_SHARE:.0e} of the elements, or {KINK_FLOOR})")
        if not kink <= max(KINK_FLOOR, KINK_SHARE * away.numel()):
            raise AssertionError(f"K4{tag} {label}: {kink} elements next to the kink")
        check("K4", label, run, operands, library, keep=keep, cot_mask=away)
        # The backward kernel alone.
        with torch.no_grad():
            xd, wd, bd = x.detach(), weight.detach(), bias.detach()
            xbd = None if xbias is None else xbias.detach()
            _, stats = gn_apply._forward_launch(xd, wd, bd, None, 4, xbd, stats=True)
            dy = torch.randn(shape, generator=g).to(dev, dtype)
            got = gn_apply.group_norm_act_backward(xd, wd, bd, 4, stats, dy, xbd)
            ref = gn_apply.group_norm_act_backward_plain(xd, wd, bd, 4, stats, dy, xbd)
            pairs = [(a, r) for a, r in zip(got, ref) if r is not None]
            err = worst_relative(*zip(*pairs))
            abs_err = max((a.float() - r.float()).abs().max().item() for a, r in pairs)
            t = {"ms": graph_ms(lambda: gn_apply.group_norm_act_backward(
                     xd, wd, bd, 4, stats, dy, xbd)),
                 "plain_ms": graph_ms(lambda: gn_apply.group_norm_act_backward_plain(
                     xd, wd, bd, 4, stats, dy, xbd))}
        b = bound(nbytes(xd, dy, got[0], wd, bd, stats, *got[1:3]), 16 * xd.numel())
        p = gn_apply.plan(shape, 4, dtype, sms, backward=True)
        log(f"K4{tag} backward kernel {label}: against its plain version {err:.3e} of "
            f"max|plain| (bar {BACKWARD_BAR:.0e}); {p.route}, {p.blocks} blocks; device: "
            f"kernel {t['ms']:.4f} ms, plain version {t['plain_ms']:.4f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]})")
        if not err <= BACKWARD_BAR:
            raise AssertionError(f"K4{tag} backward kernel disagrees with its plain version "
                                 f"at {label}")
        entry = {"max_rel_err": err, "max_abs_err": abs_err, **t, "bound_ms": b[0],
                 "bound_by": b[1],
                 "gn_route": p.route, "blocks": p.blocks, "kink_elements": kink}
        old = results.get("K4 kernel")
        if old is None or keep:
            results["K4 kernel"] = {**entry, "max_rel_err": max(
                err, old["max_rel_err"] if old else 0.0), "max_abs_err": max(
                abs_err, old["max_abs_err"] if old else 0.0)}
        else:
            old["max_rel_err"] = max(old["max_rel_err"], err)
            old["max_abs_err"] = max(old["max_abs_err"], abs_err)
    results["K4 kernel"]["library_ms"] = results["K4"]["library_ms"]
    k2_section()
    return results


def chain_legs(refiner, feats0, image_rest, H_inc, cot, got, ref, tf32=False):
    """K2's Function (gradients ``got`` of feats0 and the refiner's weights, for output
    gradient ``cot``) against plain autograd (``ref``) by CHAIN_LEGS' bars for its variant
    (bf16 storage, ``tf32``: the 1xTF32 variant, or f32): the Function against its closed
    form (``incremental_chain_backward_plain``) on what the kernel's forward kept; that
    closed form on what the plain forward gives (``saved_forward``, the forward kernel's
    plain version, its operands rounded as the variant's) against plain autograd through
    that same forward; what the kernel kept against that plain forward's tensors; the
    LeakyReLU branches the two forwards take apart (``branch_flips`` of ``gn_values``,
    the largest |z| among them); and the direct gap. Returns the readings, the bars and
    ``missed``, the names of the readings outside them."""
    from multi_view_stereonet_tpu_torch.ops import precision
    from multi_view_stereonet_tpu_torch.ops.cuda import closed_form
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain

    dtype = feats0.dtype
    variant = "bf16" if dtype == torch.bfloat16 else "tf32" if tf32 else "f32"
    bars = CHAIN_LEGS[variant]
    image_rest = image_rest.to(dtype)
    needs = (True, False, False, True)
    f0 = feats0.detach()
    # Deterministic, so that the plain side reads the same from run to run.
    with deterministic(True):
        with torch.enable_grad():
            leaves = [f0.clone().requires_grad_(),
                      *(t.detach().clone().requires_grad_() for t in chain._weights(refiner))]
            plain = chain.saved_forward(leaves[1:], leaves[0], image_rest, H_inc, tf32)
            auto = torch.autograd.grad(plain[0], leaves, cot)
        with torch.no_grad(), precision.scope("ieee"):
            plain = [t.detach() for t in plain]
            kept = chain._forward_launch(f0, image_rest, H_inc, *chain._weight_args(refiner), 0,
                                         tf32, True)
            closed_k = chain.incremental_chain_backward_plain(refiner, f0, image_rest, H_inc,
                                                              *kept, cot, needs, tf32)
            closed_p = chain.incremental_chain_backward_plain(refiner, f0, image_rest, H_inc,
                                                              *plain, cot, needs, tf32)
            forward = max(worst_relative([kept[0].float()], [plain[0].float()]),
                          worst_relative([kept[1]], [plain[1]]),
                          worst_relative(kept[2].unbind(-2), plain[2].unbind(-2)))
            flips, flip_z, values = 0, 0.0, 0
            res = refiner.res0
            for gn, (gamma, beta) in enumerate(((refiner.bn0.weight, refiner.bn0.bias),
                                                (res.bn1.weight, res.bn1.bias))):
                z = [closed_form._gn_forward(raw[:, :, gn].flatten(0, 1),
                                             stats[:, :, gn].flatten(0, 1),
                                             gamma.detach(), beta.detach())[1]
                     for _, raw, stats in (kept, plain)]
                apart = (closed_form._leaky_slope(z[0], dtype)
                         != closed_form._leaky_slope(z[1], dtype))
                flips += int(apart.sum())
                values += apart.numel()
                if apart.any():
                    flip_z = max(flip_z, z[0][apart].abs().max().item())
    r = {"function_vs_closed_form": worst_relative(got, [closed_k[0], *closed_k[3]]),
         "closed_form_vs_autograd": worst_relative([closed_p[0], *closed_p[3]], auto),
         "forward": forward, "direct": worst_relative(got, ref), "branch_flips": flips,
         "gn_values": values, "flip_max_abs_z": flip_z, "variant": variant, "bars": bars}
    within = {"function_vs_closed_form": r["function_vs_closed_form"] <= bars["leg"],
              "closed_form_vs_autograd": r["closed_form_vs_autograd"] <= bars["leg"],
              "forward": forward <= bars["forward"],
              "branch_flips": flips <= max(KINK_FLOOR, bars["flip_share"] * values),
              "flip_max_abs_z": flip_z <= bars["flip_z"],
              "direct": (r["direct"] <= bars["direct"]
                         or (flips > 0 and variant != "bf16"))}
    r["missed"] = [k for k, ok in within.items() if not ok]
    return r


def plain_branch_inputs(forward, module, guidance, idepth):
    """The module's plain forward ``forward(module, guidance, idepth)`` at f32: the inputs
    of its seven LeakyReLUs (each GroupNorm's value z, NHWC) and of its output ReLU, read
    as it calls ``F.leaky_relu`` and ``torch.relu``."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    seen = {F.leaky_relu: [], torch.relu: []}

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in seen:
                seen[func].append(args[0].detach())
            return func(*args, **(kwargs or {}))
    with torch.no_grad(), Record():
        forward(module, guidance, idepth)
    return [z.permute(0, 2, 3, 1) for z in seen[F.leaky_relu]], seen[torch.relu][-1]


def refiner_legs(module, guidance, idepth, cot, got, ref, tf32=False):
    """K3's Function (gradients ``got`` of guidance, idepth and the refiner's weights, for
    output gradient ``cot``) against plain autograd (``ref``) by REFINER_LEGS' bars for its
    variant, as ``chain_legs`` holds K2: the Function against its closed form
    (``idepthmap_refiner_backward_plain``) on what the kernel's forward kept; that closed
    form on what the plain forward gives (``saved_forward``, the forward kernel's plain
    version) against plain autograd through that same forward; what the kernel kept (out,
    raw, the statistics) against that plain forward's tensors; the LeakyReLU branches of
    the seven GroupNorms and the output ReLU's that the two forwards take apart, and the
    largest |z| among them; the Function against autograd through that plain forward
    (``direct_saved``, held unless branches are apart). Then the direct gap, to plain
    autograd through the module (``ref``): at f32 and TF32 the branches that the kernel's
    forward and the module's plain forward (``plain_branch_inputs``) take apart are counted
    by the same bars, and the direct bar is held unless some are. At bf16 also how far the
    Function's and plain autograd's gradients each lie from the f32 gradient of the same
    inputs (the closed form on the f32 plain forward), unbarred. Returns the readings, the
    bars and ``missed``."""
    from multi_view_stereonet_tpu_torch.ops.cuda import closed_form
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

    dtype = guidance.dtype
    variant = "bf16" if dtype == torch.bfloat16 else "tf32" if tf32 else "f32"
    bars = REFINER_LEGS[variant]
    needs = (True, True, True)
    g0, i0 = guidance.detach(), idepth.detach()
    weights = [p.detach() for p in module.parameters()]
    # The module's plain forward as ``ref``'s autograd took it: outside the deterministic
    # flags, which could pick another cuDNN algorithm and so another rounding.
    module_z = None if variant == "bf16" else plain_branch_inputs(
        refiner_op.idepthmap_refiner_tf32_plain if tf32 else refiner_op.idepthmap_refiner_plain,
        module, g0, i0)
    with deterministic(True):
        with torch.enable_grad():
            leaves = [g0.clone().requires_grad_(), i0.clone().requires_grad_(),
                      *(t.clone().requires_grad_() for t in weights)]
            plain = refiner_op.saved_forward(leaves[2:], leaves[0], leaves[1],
                                             refiner_op._dilations(module), tf32)
            auto = torch.autograd.grad(plain[0], leaves, cot)
        with torch.no_grad():
            plain = [t.detach() for t in plain]
            out, (raw, stats, _, _) = refiner_op._launch(module, g0, i0, tf32, keep=True)
            closed_k = refiner_op.idepthmap_refiner_backward_plain(module, g0, i0, out, raw,
                                                                   stats, cot, needs, tf32)
            closed_p = refiner_op.idepthmap_refiner_backward_plain(module, g0, i0, *plain, cot,
                                                                   needs, tf32)
            forward = max(worst_relative([out], [plain[0]]), worst_relative([raw], [plain[1]]),
                          worst_relative(stats.unbind(2), plain[2].unbind(2)))
            z_kernel = [closed_form._gn_forward(raw[k], stats[k],
                                                *weights[4 * k + 2:4 * k + 4])[1]
                        for k in range(refiner_op.NUM_GN)]
            z_saved = [closed_form._gn_forward(plain[1][k], plain[2][k],
                                               *weights[4 * k + 2:4 * k + 4])[1]
                       for k in range(refiner_op.NUM_GN)]

            def branches_apart(zs, pre_relu):
                """(flips, values, the largest |z| among the flips) of the kernel's forward
                against another forward's LeakyReLU inputs ``zs`` and output ReLU input."""
                apart = (out > 0) != (pre_relu > 0)
                flips, values = int(apart.sum()), apart.numel()
                flip_z = out[apart].abs().max().item() if apart.any() else 0.0
                for zk, zo in zip(z_kernel, zs):
                    apart = (closed_form._leaky_slope(zk, dtype)
                             != closed_form._leaky_slope(zo, dtype))
                    flips += int(apart.sum())
                    values += apart.numel()
                    if apart.any():
                        flip_z = max(flip_z, zk[apart].abs().max().item())
                return flips, values, flip_z
            flips, values, flip_z = branches_apart(z_saved, plain[0])
            module_flips = None if module_z is None else branches_apart(*module_z)

    def flat(grads):
        return [grads[0], grads[1], *grads[2]]
    r = {"function_vs_closed_form": worst_relative(got, flat(closed_k)),
         "closed_form_vs_autograd": worst_relative(flat(closed_p), auto),
         "forward": forward, "direct": worst_relative(got, ref),
         "direct_saved": worst_relative(got, auto), "branch_flips": flips,
         "gn_values": values, "flip_max_abs_z": flip_z, "variant": variant, "bars": bars,
         "module_branch_flips": None if module_flips is None else module_flips[0],
         "module_flip_max_abs_z": None if module_flips is None else module_flips[2]}
    if variant == "bf16":
        with torch.no_grad():
            g32 = g0.float()
            f32 = flat(refiner_op.idepthmap_refiner_backward_plain(
                module, g32, i0, *refiner_op.idepthmap_refiner_saved_plain(module, g32, i0),
                cot))
        r["function_vs_f32"] = worst_relative(got, f32)
        r["autograd_vs_f32"] = worst_relative(ref, f32)
    within = {"function_vs_closed_form": r["function_vs_closed_form"] <= bars["leg"],
              "closed_form_vs_autograd": r["closed_form_vs_autograd"] <= bars["leg"],
              "forward": forward <= bars["forward"],
              "branch_flips": flips <= max(KINK_FLOOR, bars["flip_share"] * values),
              "flip_max_abs_z": flip_z <= bars["flip_z"],
              "direct_saved": (r["direct_saved"] <= bars["direct"]
                               or (flips > 0 and variant != "bf16")),
              "direct": (r["direct"] <= bars["direct"]
                         or (module_flips is not None and module_flips[0] > 0))}
    if module_flips is not None:
        within["module_branch_flips"] = module_flips[0] <= max(
            KINK_FLOOR, bars["flip_share"] * module_flips[1])
        within["module_flip_max_abs_z"] = module_flips[2] <= bars["flip_z"]
    r["missed"] = [k for k, ok in within.items() if not ok]
    return r


def describe_legs(r) -> str:
    """``chain_legs``' or ``refiner_legs``' readings and bars, for the log."""
    b = r["bars"]
    saved_held = r["branch_flips"] == 0 or r["variant"] == "bf16"
    module = r.get("module_branch_flips")
    direct_held = not module if "direct_saved" in r else saved_held
    return (f"in two legs (bar {b['leg']:.0e} each): the Function against its closed form "
            f"on what the kernel's forward kept {r['function_vs_closed_form']:.3e}, the "
            f"closed form on what the plain forward gives against autograd through that "
            f"forward {r['closed_form_vs_autograd']:.3e}; what the kernel's forward kept "
            f"against the plain forward's {r['forward']:.3e} (bar {b['forward']:.0e}); "
            f"LeakyReLU branches the two forwards take apart {r['branch_flips']} of "
            f"{r['gn_values']} (bar {b['flip_share']:.0e} of them or {KINK_FLOOR}), |z| "
            f"within {r['flip_max_abs_z']:.2e} of 0 (bar {b['flip_z']:.0e}); "
            + ("" if "direct_saved" not in r else
               f"the Function against autograd through the plain forward "
               f"{r['direct_saved']:.3e} (bar {b['direct']:.2g}, "
               f"{'held' if saved_held else 'not held: branches apart'}); ")
            + ("" if module is None else
               f"branches the kernel's forward and the module's plain forward take apart "
               f"{module}, |z| within {r['module_flip_max_abs_z']:.2e} of 0; ")
            + f"the direct gap {r['direct']:.3e} (bar {b['direct']:.2g}, "
            f"{'held' if direct_held else 'not held: branches apart'})"
            + (f"; from the f32 gradient: the Function {r['function_vs_f32']:.3e}, plain "
               f"autograd {r['autograd_vs_f32']:.3e}" if "function_vs_f32" in r else "")
            + f"{'; MISSED ' + ', '.join(r['missed']) if r['missed'] else ''}")


def gn_kink_mask(x, weight, bias, xbias):
    """False where K4's GroupNorm value z = x_hat gamma + beta lies within KINK_ROUNDING
    (|x_hat gamma| + |beta| + |mean rstd gamma|) of LeakyReLU's kink at 0, z and the
    statistics in f64 from x (+ xbias) alone, apart from either forward; True elsewhere."""
    with torch.no_grad():
        N, C = x.shape[:2]
        v = x.detach().double().reshape(N, 4, -1)
        if xbias is not None:
            v = v + xbias.detach().double().reshape(4, -1).repeat_interleave(
                v.shape[2] // (C // 4), 1)
        mean = v.mean(2, keepdim=True)
        rstd = 1.0 / torch.sqrt(((v - mean) ** 2).mean(2, keepdim=True) + 1e-5)
        v = v.reshape(N, C, -1)
        mean, rstd = mean.repeat_interleave(C // 4, 1), rstd.repeat_interleave(C // 4, 1)
        gamma = weight.detach().double().reshape(1, C, 1)
        beta = bias.detach().double().reshape(1, C, 1)
        xg = (v - mean) * rstd * gamma
        terms = xg.abs() + beta.abs() + (mean * rstd * gamma).abs()
        return ((xg + beta).abs() > KINK_ROUNDING * terms).reshape(x.shape)


def group_norm_device_ms(prof) -> dict:
    """Device ms (the profile's total over its calls) of aten::native_group_norm and its
    backward, and of K4's kernels by name (the forward's pair, the backward)."""
    from torch.autograd import DeviceType

    out = {"native_group_norm_ms": 0.0, "native_group_norm_calls": 0,
           "native_group_norm_backward_ms": 0.0, "k4_forward_ms": 0.0, "k4_backward_ms": 0.0}
    for e in prof.key_averages():
        if e.key == "aten::native_group_norm":
            out["native_group_norm_ms"] += e.device_time_total / 1e3
            out["native_group_norm_calls"] += e.count
        elif e.key == "aten::native_group_norm_backward":
            out["native_group_norm_backward_ms"] += e.device_time_total / 1e3
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if "gn_bwd_kernel" in e.name:
            out["k4_backward_ms"] += e.time_range.elapsed_us() / 1e3
        elif any(k in e.name for k in ("gn_stats_kernel", "gn_apply_kernel")):
            out["k4_forward_ms"] += e.time_range.elapsed_us() / 1e3
    out["k4_ms"] = out["k4_forward_ms"] + out["k4_backward_ms"]
    return out


def deterministic(on):
    """Within it, with ``on``, cuDNN and PyTorch run their deterministic algorithms (a
    warning where an operation has none)."""
    stack = contextlib.ExitStack()
    if on:
        stack.enter_context(torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False))
        previous = (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        stack.callback(torch.use_deterministic_algorithms, previous[0],
                       warn_only=previous[1])
    return stack


def train_phase(dev, inputs, smi):
    """Phase 7: the training CLI at full width, resumed and evaluated; then one batch
    through the kernel and plain paths: gradients, ms a step, memory, the repack and a
    profile. Returns (train() launches, summary)."""
    from multi_view_stereonet_tpu_torch.checkpoint import native, random_state_dict
    from multi_view_stereonet_tpu_torch.data.loader import collate
    from multi_view_stereonet_tpu_torch.eval.test_cli import run_eval
    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    data_dir, split = inputs["long"]
    cfg = load_params_yaml(None)  # the recipe: B = 8, 480x640, D = 12, adam 1e-3, augment
    cfg.update({"num_workers": 4, "num_val_images": VAL_IMAGES, "debug_image_freq": 0,
                "plot_freq": 0})
    if (cfg["batch_size"], tuple(cfg["size"]), cfg["num_idepth_samples"]) != (
            TRAIN_B, (H0, W0), D) or not (cfg["augment"] and all(cfg["refiners"])):
        raise AssertionError(f"the recipe's defaults moved: {cfg}")
    out = os.path.join(inputs["root"], "train")
    val_forwards = -(-VAL_IMAGES // TRAIN_B)

    def run(max_steps, num_epochs, forwards):
        """One train() call; its launches, seconds and the host time at the end of each
        step (``stop_check`` runs once a step, after the step is queued)."""
        stamps = []

        def stamp():
            stamps.append(time.perf_counter())
            return False
        zero_launches()
        t0 = time.perf_counter()
        train_cli.train(dict(cfg, num_epochs=num_epochs), data_dir, split, split, out,
                        max_steps=max_steps, stop_check=stamp, device=dev)
        seconds = time.perf_counter() - t0
        launches, backward = read_launches(), backward_launches()
        expected = expected_launches([(TRAIN_B, 1)] * forwards)
        steps = forwards - val_forwards
        want = {**expected_backward(steps), "gn_apply": expected["gn_apply"] * steps // forwards}
        passes = {k: want[k] // BACKWARD_PER[k] for k in WGRAD_KERNELS}
        if launches != expected or backward != want or wgrad_launches() != passes:
            raise AssertionError(f"train: expected launches {expected}, backward launches "
                                 f"{want} and weight-gradient passes {passes}, got "
                                 f"{launches}, {backward} and {wgrad_launches()}")
        return launches, seconds, stamps

    launches, seconds, stamps = run(TRAIN_STEPS, 1, TRAIN_STEPS + val_forwards)
    train_backward, train_wgrad = backward_launches(), wgrad_launches()
    # The loop reads each step's loss after queuing the next, so from the third step on
    # the time between steps is the CLI's rate, loader included.
    gaps = np.diff(stamps)[2:] * 1e3
    cli_ms = float(np.median(gaps))
    log(f"train: {TRAIN_STEPS} steps at B={TRAIN_B} V=1 {H0}x{W0} D={D} and validation over "
        f"{VAL_IMAGES} images in {seconds:.1f} s (loader start-up, first calls and the "
        f"checkpoint included); launches {launches}: per forward {TRAIN_STEPS} steps + "
        f"{val_forwards} validation batches, and backward launches {train_backward} (K4's "
        f"forward launches of the {TRAIN_STEPS} steps, K2 two a step, K3 two a fused refiner, "
        f"K1 none; of those the weight-gradient passes {train_wgrad}); the CLI loop "
        f"{cli_ms:.3f} ms a step (median of steps 4-{TRAIN_STEPS}, host clock; "
        f"{[round(g, 1) for g in gaps]}), {TRAIN_B * 1e3 / cli_ms:.2f} images/s ({smi})")
    _, resume_seconds, _ = run(TRAIN_STEPS + RESUME_STEPS, 2, RESUME_STEPS + val_forwards)
    with open(os.path.join(out, "losses.txt")) as f:
        rows = [line.split() for line in f.read().splitlines()[1:]]
    steps = [int(r[2]) for r in rows]
    losses = [float(r[3]) for r in rows]
    root = os.path.join(out, "checkpoints")
    if (steps != list(range(1, TRAIN_STEPS + RESUME_STEPS + 1)) or not np.isfinite(losses).all()
            or native.latest_epoch(root) != 1
            or native.load_train_state(root, 1)["step"] != TRAIN_STEPS + RESUME_STEPS):
        raise AssertionError(f"train: steps {steps}, losses {losses}")
    with open(os.path.join(out, "validation.txt")) as f:
        val_rows = f.read().splitlines()
    log(f"train: resumed from epoch 0 for {RESUME_STEPS} steps in {resume_seconds:.1f} s; "
        f"losses by step {[round(x, 3) for x in losses]}, all finite; validation.txt "
        f"{val_rows}")
    data_dir1, split1 = inputs["trees"][1]
    eval_out = os.path.join(inputs["root"], "eval_trained")
    eval_loss, avg = run_eval(os.path.join(root, "epoch0001"), data_dir1, split1, eval_out,
                              batch_size=2, params_file=inputs["params_yaml"],
                              decode_backend="pil", device=dev)
    if not (np.isfinite(eval_loss) and os.path.exists(
            os.path.join(eval_out, "avg_depth_metrics.txt"))):
        raise AssertionError(f"run_eval of the trained checkpoint: loss {eval_loss}")
    log(f"train: run_eval of checkpoints/epoch0001/stereo_network.pth over "
        f"{avg['num_samples']} images: loss {eval_loss:.4f}, abs_rel {avg['abs_rel']:.4f}")

    # The recipe's loader alone (augmentation on, 4 workers), one epoch: whether it keeps
    # up with the step.
    dataset = train_cli.make_dataset(cfg, data_dir, split, True, 0, np.random.default_rng(0))
    loader_stamps = [time.perf_counter() for _ in train_cli.BatchLoader(
        dataset, TRAIN_B, shuffle=True, seed=0, workers=cfg["num_workers"])]
    loader_ms = float(np.median(np.diff(loader_stamps)[1:])) * 1e3
    log(f"train: the loader alone, augmentation on, {cfg['num_workers']} workers: "
        f"{loader_ms:.3f} ms a batch of {TRAIN_B} (median over an epoch of "
        f"{len(loader_stamps)} batches, host clock), {TRAIN_B * 1e3 / loader_ms:.2f} images/s")

    # One batch of the recipe, as the loader gives it, on the card.
    batch = collate([dataset[i] for i in range(TRAIN_B)])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if not k.endswith("filenames")}
    state0 = random_state_dict(0)

    def fresh(impl):
        model = MultiViewStereoNet()
        model.load_state_dict(state0)
        model = model.to(dev)
        config, loss_config, _, step = train_cli.build_train_step(cfg, 12, model, impl)
        return model, config, loss_config, step

    # Gradients, kernel path against plain, from the same weights and batch.
    grads, loss_of = {}, {}
    for impl in ("auto", "plain"):
        model, config, loss_config, _ = fresh(impl)
        zero_launches()
        loss, _ = make_loss_fn(config, loss_config, impl=impl)(model, batch)
        forward = read_launches()
        loss.backward()
        torch.cuda.synchronize()
        expected = (expected_launches([(TRAIN_B, 1)]) if impl == "auto"
                    else dict.fromkeys(forward, 0))
        want = ({**expected_backward(1), "gn_apply": expected["gn_apply"]} if impl == "auto"
                else dict.fromkeys(BACKWARD_KERNELS, 0))
        if not (forward == read_launches() == expected and backward_launches() == want):
            raise AssertionError(f"{impl}: forward launches {forward}, after the backward "
                                 f"{read_launches()} and backward launches "
                                 f"{backward_launches()}, expected {expected} and {want}")
        loss_of[impl] = loss.item()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
        if impl == "auto":
            step_backward = backward_launches()
            log(f"train step launches: forward {forward}, backward kernels {step_backward} "
                f"(K4 once a K4 forward launch, K2 two, K3 two a fused refiner, K1 "
                f"none), no forward kernel")
    ref = grads["plain"]
    worst, worst_key, min_cos = compare_gradients(grads)
    loss_gap = abs(loss_of["auto"] - loss_of["plain"]) / abs(loss_of["plain"])
    log(f"train step kernel vs plain (TF32 off, same weights and batch): loss "
        f"{loss_of['auto']:.6f} vs {loss_of['plain']:.6f} ({loss_gap:.2e} relative, bar "
        f"{LOSS_BAR:.0e}); worst gradient {worst:.3e} of max|plain| at {worst_key} (bar "
        f"{GRAD_BAR:.1e}), least cosine {min_cos:.9f} (bar {COS_BAR}), over {len(ref)} "
        f"parameters")
    if not (np.isfinite(loss_of["auto"]) and loss_gap <= LOSS_BAR and worst <= GRAD_BAR
            and min_cos > COS_BAR):
        raise AssertionError("the kernel path's training gradients miss the bar")
    del grads

    # ms a step: kernel and plain paths in turns, two warm-up steps each first.
    steps_by = {impl: fresh(impl) for impl in ("auto", "plain")}
    times, peak = time_steps(steps_by, batch)
    ms = {impl: statistics.median(t) for impl, t in times.items()}
    for impl in ("auto", "plain"):
        log(f"train step {'kernel' if impl == 'auto' else 'plain'} path, B={TRAIN_B} V=1 "
            f"{H0}x{W0} D={D}, adam: {ms[impl]:.3f} ms a step (median of "
            f"{len(times[impl])}, CUDA events; {[round(t, 2) for t in times[impl]]}), "
            f"{TRAIN_B * 1e3 / ms[impl]:.2f} images/s, peak memory "
            f"{peak[impl] / 2**30:.3f} GiB ({smi})")

    # The K3 repack each optimizer step causes (the weights' versions moved).
    module = steps_by["auto"][0].refiner4
    host, dev_ms = [], []
    for _ in range(10):
        with torch.no_grad():
            module.conv0.bias.add_(0.0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        refiner_op.packed_weights(module)
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    repack = {"host_ms": statistics.median(host), "events_ms": statistics.median(dev_ms)}
    log(f"K3 repack after a weight update: host {repack['host_ms']:.3f} ms, CUDA events "
        f"{repack['events_ms']:.3f} ms (median of 10; two fused refiners a step)")

    # Device time of the forward alone and of one whole step on each path (torch.profiler,
    # kernels summed): what the backward and the optimizer step take; the top device
    # operations of one kernel-path step.
    device = {}
    for impl, (model, config, loss_config, step) in steps_by.items():
        loss_fn = make_loss_fn(config, loss_config, impl=impl)
        forward = device_ms(lambda: loss_fn(model, batch), reps=3, warmup=1)
        busy, wall, prof = profile_kernels(lambda: step(model, batch), 1)
        gn_ops = group_norm_device_ms(prof)
        device[impl] = {"forward_ms": forward, "busy_ms": busy, "wall_ms": wall, **gn_ops}
        k4_calls, k4_bound = k4_step_backward_bound()
        log(f"train step profile ({'kernel' if impl == 'auto' else 'plain'} path, a step): "
            f"device busy {busy:.3f} ms of {wall:.3f} ms wall (profiler on), idle "
            f"{max(0.0, 1 - busy / wall):.1%}; the forward alone {forward:.3f} ms device "
            f"(mean of 3), the backward and the optimizer step {busy - forward:.3f} ms; "
            f"aten::native_group_norm {gn_ops['native_group_norm_ms']:.3f} ms in "
            f"{gn_ops['native_group_norm_calls']} calls and its backward "
            f"{gn_ops['native_group_norm_backward_ms']:.3f} ms, K4's kernels "
            f"{gn_ops['k4_ms']:.3f} ms (forward {gn_ops['k4_forward_ms']:.3f}, backward "
            f"{gn_ops['k4_backward_ms']:.3f}; the bound of its {k4_calls} backward launches "
            f"{k4_bound:.3f} ms); peak memory {peak[impl] / 2**30:.3f} GiB ({smi})")
        if impl == "auto":
            log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    after = {impl: d["busy_ms"] - d["forward_ms"] for impl, d in device.items()}
    log(f"train step backward + optimizer step, device: kernel path {after['auto']:.3f} ms, "
        f"plain path {after['plain']:.3f} ms; the kernels' backward (K2's, K3's and K4's "
        f"kernels) adds {after['auto'] - after['plain']:.3f} ms, their forward saves "
        f"{device['plain']['forward_ms'] - device['auto']['forward_ms']:.3f} ms ({smi})")
    summary = {"ms": ms, "images_s": {k: TRAIN_B * 1e3 / v for k, v in ms.items()},
               "backward_launches": train_backward, "step_backward_launches": step_backward,
               "wgrad_launches": train_wgrad,
               "cli_ms": cli_ms, "loader_ms": loader_ms,
               "peak_gib": {k: v / 2**30 for k, v in peak.items()}, "repack": repack,
               "device": device, "grad_err": worst, "loss_gap": loss_gap}
    return launches, summary


def two_view_phase(dev, inputs, smi):
    """Phase 8: the two-view recipe with every loss branch at full width, through
    ``train_cli.train`` and resumed; then one batch through the kernel and plain paths:
    launches, the loss and gradients, ms a step and memory. Returns (one step's
    launches, summary)."""
    from multi_view_stereonet_tpu_torch.checkpoint import native, random_state_dict
    from multi_view_stereonet_tpu_torch.data.loader import collate
    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    data_dir, split = inputs["long"]
    cfg = load_params_yaml(None)  # the recipe: B = 8, 480x640, D = 12, adam 1e-3, augment
    cfg.update({"num_workers": 4, "debug_image_freq": 0, "plot_freq": 0,
                "estimate_right_idepthmap": True, **TWO_VIEW_FACTORS})
    out = os.path.join(inputs["root"], "train_two_view")

    def run(max_steps, num_epochs, steps):
        zero_launches()
        t0 = time.perf_counter()
        train_cli.train(dict(cfg, num_epochs=num_epochs), data_dir, split, "", out,
                        max_steps=max_steps, device=dev)
        seconds = time.perf_counter() - t0
        launches, expected = read_launches(), two_view_launches(steps)
        backward, want = backward_launches(), expected_backward(steps, two_view=True)
        if launches != expected or {k: backward[k] for k in want} != want:
            raise AssertionError(f"two-view train: expected launches {expected} and backward "
                                 f"launches {want}, got {launches} and {backward}")
        return launches, seconds, backward

    launches, seconds, train_backward = run(TWO_VIEW_STEPS, 1, TWO_VIEW_STEPS)
    _, resume_seconds, _ = run(TWO_VIEW_STEPS + TWO_VIEW_RESUME, 2, TWO_VIEW_RESUME)
    with open(os.path.join(out, "losses.txt")) as f:
        header, *rows = [line.split() for line in f.read().splitlines()]
    steps = [int(r[2]) for r in rows]
    values = np.array([[float(x) for x in r[3:]] for r in rows])
    root = os.path.join(out, "checkpoints")
    columns = {"loss", "supervised_loss", "reconstruction_loss", "left_right_loss"}
    if (steps != list(range(1, TWO_VIEW_STEPS + TWO_VIEW_RESUME + 1))
            or not columns <= set(header) or not np.isfinite(values).all()
            or native.load_train_state(root, 1)["step"] != TWO_VIEW_STEPS + TWO_VIEW_RESUME):
        raise AssertionError(f"two-view train: steps {steps}, header {header}, {values}")
    col = {k: values[:, header.index(k) - 3] for k in sorted(columns)}
    log(f"two-view train: {TWO_VIEW_STEPS} steps at B={TRAIN_B} {H0}x{W0} D={D} in "
        f"{seconds:.1f} s, resumed for {TWO_VIEW_RESUME} in {resume_seconds:.1f} s "
        f"(loader start-up, first calls and checkpoints included); launches {launches}, "
        f"backward launches {train_backward}; "
        f"losses.txt has {len(header) - 3} columns, all finite: "
        + "; ".join(f"{k} {[round(float(x), 4) for x in v]}" for k, v in col.items()))

    # One batch of the recipe, as the loader gives it, adapted to the two-view step.
    dataset = train_cli.make_dataset(cfg, data_dir, split, True, 0, np.random.default_rng(1))
    batch = collate([dataset[i] for i in range(TRAIN_B)])
    batch = train_cli.two_view_batch({k: torch.as_tensor(v).to(dev) for k, v in batch.items()
                                      if not k.endswith("filenames")})
    state0 = random_state_dict(0)

    def fresh(impl):
        model = MultiViewStereoNet()
        model.load_state_dict(state0)
        model = model.to(dev)
        config, loss_config, _, step = train_cli.build_train_step(cfg, 12, model, impl)
        return model, config, loss_config, step

    grads, loss_of, step_launches = {}, {}, None
    for impl in ("auto", "plain"):
        model, config, loss_config, _ = fresh(impl)
        loss_fn = make_loss_fn(config, loss_config, multi_view=False,
                               estimate_right_idepthmap=True, impl=impl)
        zero_launches()
        loss, loss_dict = loss_fn(model, batch)
        forward = read_launches()
        loss.backward()
        torch.cuda.synchronize()
        expected = two_view_launches(1) if impl == "auto" else dict.fromkeys(forward, 0)
        want = (expected_backward(1, two_view=True) if impl == "auto"
                else {"warp": 0, "chain": 0, "refiner": 0})
        backward = backward_launches()
        if not (forward == read_launches() == expected
                and {k: backward[k] for k in want} == want):
            raise AssertionError(f"two-view {impl}: forward launches {forward}, after the "
                                 f"backward {read_launches()} and backward launches "
                                 f"{backward}, expected {expected} and {want}")
        loss_of[impl] = {k: loss_dict[k].item() for k in ("supervised_loss", "left_right_loss",
                                                          "reconstruction_loss")}
        loss_of[impl]["loss"] = loss.item()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
        if impl == "auto":
            step_launches = {"forward": forward, "backward": backward}
            log(f"two-view step launches: {forward} (K1: 2 a forward, two forwards, and "
                f"{loss_warp_launches(NUM_LEVELS)} in the losses); backward kernels "
                f"{backward} (K1 {want['warp']} in the losses, K2 {want['chain']}), no "
                f"forward kernel")
    worst, worst_key, min_cos = compare_gradients(grads)
    loss_gap = abs(loss_of["auto"]["loss"] - loss_of["plain"]["loss"]) / abs(
        loss_of["plain"]["loss"])
    log(f"two-view step kernel vs plain (TF32 off, same weights and batch): losses "
        f"{loss_of['auto']} vs {loss_of['plain']} ({loss_gap:.2e} relative, bar "
        f"{LOSS_BAR:.0e}); worst gradient {worst:.3e} of max|plain| at {worst_key} (bar "
        f"{GRAD_BAR:.1e}), least cosine {min_cos:.9f} (bar {COS_BAR}), over "
        f"{len(grads['plain'])} parameters")
    if not (np.isfinite(loss_of["auto"]["loss"]) and loss_gap <= LOSS_BAR
            and worst <= GRAD_BAR and min_cos > COS_BAR):
        raise AssertionError("the kernel path's two-view gradients miss the bar")
    del grads

    steps_by = {impl: fresh(impl) for impl in ("auto", "plain")}
    times, peak = time_steps(steps_by, batch, per_round=3)
    ms = {impl: statistics.median(t) for impl, t in times.items()}
    for impl in ("auto", "plain"):
        log(f"two-view step {'kernel' if impl == 'auto' else 'plain'} path, B={TRAIN_B} "
            f"{H0}x{W0} D={D}, adam, every loss: {ms[impl]:.3f} ms a step (median of "
            f"{len(times[impl])}, CUDA events; {[round(t, 2) for t in times[impl]]}), "
            f"{TRAIN_B * 1e3 / ms[impl]:.2f} images/s, peak memory "
            f"{peak[impl] / 2**30:.3f} GiB ({smi})")
    # Device time of one kernel-path step (torch.profiler, kernels summed), of its
    # forward (both forwards and the losses) alone, and the top device operations.
    model, config, loss_config, step = steps_by["auto"]
    loss_fn = make_loss_fn(config, loss_config, multi_view=False,
                           estimate_right_idepthmap=True)
    forward = device_ms(lambda: loss_fn(model, batch), reps=3, warmup=1)
    busy, wall, prof = profile_kernels(lambda: step(model, batch), 1)
    log(f"two-view step profile (kernel path, a step): device busy {busy:.3f} ms of "
        f"{wall:.3f} ms wall (profiler on), idle {max(0.0, 1 - busy / wall):.1%}; the "
        f"forward (two forwards and the losses) alone {forward:.3f} ms device (mean of 3), "
        f"the backward and the optimizer step {busy - forward:.3f} ms ({smi})")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    summary = {"ms": ms, "peak_gib": {k: v / 2**30 for k, v in peak.items()},
               "grad_err": worst, "loss_gap": loss_gap, "backward_launches": train_backward,
               "device": {"forward_ms": forward, "busy_ms": busy, "wall_ms": wall}}
    return step_launches, summary


def loss_warp_launches(levels):
    """K1 launches of ``compute_losses`` with the right view's outputs and every branch
    on, over ``levels`` refined levels: occlusion masks 2 a level and 2 of the truth,
    left-right consistency 4 a level, reconstruction 2 a level."""
    return 2 * levels + 2 + 4 * levels + 2 * levels


def two_view_launches(steps):
    """Launches of ``steps`` two-view steps at the recipe: two forwards at (B, 1) a step,
    and the losses' samples."""
    total = expected_launches([(TRAIN_B, 1)] * 2 * steps)
    total["warp"] += steps * loss_warp_launches(NUM_LEVELS)
    return total


def compare_gradients(grads):
    """(worst, its parameter, least cosine) of grads["auto"] against grads["plain"] (dicts
    of parameter gradients): per parameter max|diff| over max|plain|, a leaf below
    GRAD_FLOOR of the largest held to that floor; the cosine above the floor."""
    ref = grads["plain"]
    floor = GRAD_FLOOR * max(r.abs().max().item() for r in ref.values())
    worst, worst_key, min_cos = 0.0, None, 1.0
    for k, r in ref.items():
        a = grads["auto"][k]
        err = (a - r).abs().max().item() / max(r.abs().max().item(), floor)
        if err > worst:
            worst, worst_key = err, k
        if r.abs().max().item() > floor:
            min_cos = min(min_cos, torch.nn.functional.cosine_similarity(
                a.flatten().double(), r.flatten().double(), dim=0).item())
    return worst, worst_key, min_cos


def time_steps(steps_by, batch, rounds=2, per_round=4):
    """Train steps on one batch, the paths of ``steps_by`` ({impl: (model, _, _, step)})
    in turns after two warm-up steps each: (CUDA-event ms of each step by path, peak
    memory by path). A non-finite loss raises."""
    times = {impl: [] for impl in steps_by}
    peak = {}
    for impl, (model, _, _, step) in steps_by.items():
        for _ in range(2):
            loss, _ = step(model, batch)
    for _ in range(rounds):
        for impl, (model, _, _, step) in steps_by.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(per_round):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss, _ = step(model, batch)
                end.record()
                end.synchronize()
                times[impl].append(start.elapsed_time(end))
                if not np.isfinite(loss.item()):
                    raise AssertionError(f"{impl}: a non-finite loss")
            peak[impl] = max(peak.get(impl, 0), torch.cuda.max_memory_allocated())
    return times, peak


def tests_module(name):
    """tests/<name>.py, loaded by path: an installed package named ``tests`` may shadow
    the repo's."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def synthetic_data():
    return tests_module("synthetic_data")


def write_run(root, comparisons, seed):
    """A synthetic 480x640 GTA-SfM tree with 6 - 2 * comparisons requests;
    returns (data_dir, split)."""
    return synthetic_data().make_gta_sfm_tree(
        os.path.join(root, f"v{comparisons}"), num_sequences=1, frames=6 - comparisons,
        rows=H0, cols=W0, seed=seed, comparisons=comparisons)


def kernel_modules():
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp
    return {"warp": warp, "chain": chain, "refiner": refiner_op, "gn_apply": gn_apply}


# The kernels with a backward kernel of their own: all four, by the name phase 3b checks
# them under.
BACKWARD_KERNELS = ("warp", "chain", "refiner", "gn_apply")
BACKWARD_OF = {"K1": "warp", "K2": "chain", "K3": "refiner", "K4": "gn_apply"}
# Launches a backward: K2's and K3's are two (the sequential part, then the weight-gradient
# pass), each counted in its module's ``backward_launches``; K1's and K4's one.
BACKWARD_PER = {"warp": 1, "chain": 2, "refiner": 2, "gn_apply": 1}
# The kernels with a weight-gradient pass of their own (``wgrad_launches``).
WGRAD_KERNELS = ("chain", "refiner")


def zero_launches():
    """Every forward launch counter and every backward one to 0."""
    for module in kernel_modules().values():
        module.launches = 0
    for name in BACKWARD_KERNELS:
        kernel_modules()[name].backward_launches = 0
    for name in WGRAD_KERNELS:
        kernel_modules()[name].wgrad_launches = 0


def read_launches():
    """The forward launch counters (a kernel's backward launches count apart)."""
    return {name: module.launches for name, module in kernel_modules().items()}


def backward_launches():
    """The backward kernels' launch counters: K1's, K2's, K3's and K4's."""
    return {name: kernel_modules()[name].backward_launches for name in BACKWARD_KERNELS}


def wgrad_launches():
    """The weight-gradient passes' launch counters: K2's and K3's."""
    return {name: kernel_modules()[name].wgrad_launches for name in WGRAD_KERNELS}


def expected_backward(steps, two_view=False):
    """Backward launches of K1, K2 and K3 in ``steps`` train steps at the recipe: K2's
    backward once a forward (both forwards of a two-view step), K3's once for each refiner a
    forward fuses (``expected_launches``: levels 4 and 3 at B = 8, 480x640), each of those
    two launches (``BACKWARD_PER``); K1's only in the two-view losses, where the left-right
    loss's two idepth samples a level and the reconstruction's two a level carry a gradient
    (the occlusion masks' samples feed comparisons alone, and the forward's warps sample
    data)."""
    forwards = steps * (2 if two_view else 1)
    return {"warp": steps * 4 * NUM_LEVELS if two_view else 0,
            "chain": BACKWARD_PER["chain"] * forwards,
            "refiner": BACKWARD_PER["refiner"] * forwards
            * expected_launches([(TRAIN_B, 1)])["refiner"]}


def expected_launches(forwards, rows=H0, cols=W0):
    """Launches of forwards at these (B, V) and size, all refiners on: 2 grid samples and
    1 chain each; K3 for each refiner that ``fused_refiner_supported`` takes (refiner 4
    at n = B*V, the others at n = B: levels 4 and 3 at 480x640, 4-1 at 96x128), and
    GroupNorm launches for the extractor's six resblocks, the cost filter's four and 7
    (bn0 + 6 resblocks) for each refiner it does not take: 31 at 480x640."""
    from multi_view_stereonet_tpu_torch.ops.cuda.refiner import fused_refiner_supported
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    sizes = pyramid_sizes(rows, cols, NUM_LEVELS)
    total = {"warp": 0, "chain": 0, "refiner": 0, "gn_apply": 0}
    for B, V in forwards:
        fused = sum(fused_refiner_supported(*sizes[lvl], B * V if lvl == 4 else B)
                    for lvl in range(NUM_LEVELS))
        total["warp"] += 2
        total["chain"] += 1
        total["refiner"] += fused
        total["gn_apply"] += 6 + 4 + 7 * (NUM_LEVELS - fused)
    return total


def remat_launches(B):
    """The forward launches that ``remat_refiners`` adds to a train step at (B, 1): its
    backward recomputes each refiner's forward through its kernels, K3 for those
    ``expected_launches`` fuses and 7 GroupNorm launches (bn0 + 6 resblocks) for each of the
    others (their backward launches are the step's as without it: K3's backward once a
    fused refiner)."""
    from multi_view_stereonet_tpu_torch.ops.cuda.refiner import fused_refiner_supported

    fused = (fused_refiner_supported(H0 // 16, W0 // 16, B)
             + fused_refiner_supported(H0 // 8, W0 // 8, B))
    return {"warp": 0, "chain": 0, "refiner": fused, "gn_apply": 7 * (NUM_LEVELS - fused)}


def write_inputs(root):
    """The run directory (params.yaml: 480x640, D = 12, cost filter on, five refiners;
    seeded fan-in-scale weights as stereo_network.pth) and the synthetic trees: GTA-SfM
    at V = 1 (four requests) and V = 2 (two), and DeMoN (one scene of each of two types,
    three frames each, plane depth 4.0)."""
    import yaml

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.eval.streaming import WEIGHTS_FILE

    run_dir = os.path.join(root, "run")
    weights_dir = os.path.join(run_dir, "checkpoints", "epoch0000")
    os.makedirs(weights_dir)
    with open(os.path.join(run_dir, "params.yaml"), "w") as f:
        yaml.safe_dump({"size": [H0, W0], "num_idepth_samples": D,
                        "cost_volume_filter": True, "refiners": [True] * 5}, f)
    torch.save(random_state_dict(0), os.path.join(weights_dir, WEIGHTS_FILE))
    t0 = time.perf_counter()
    trees = {v: write_run(root, v, seed=v) for v in (1, 2)}
    demon = synthetic_data().make_demon_tree(os.path.join(root, "demon"), num_scenes=1,
                                             frames=3, rows=H0, cols=W0, plane_depth=4.0)
    long = synthetic_data().make_gta_sfm_tree(
        os.path.join(root, "long"), num_sequences=1, frames=LONG + 1, rows=H0, cols=W0,
        seed=3, comparisons=1)
    log(f"inputs: wrote synthetic 480x640 trees in {time.perf_counter() - t0:.1f} s")
    return {"root": root, "weights_dir": weights_dir,
            "params_yaml": os.path.join(run_dir, "params.yaml"), "trees": trees,
            "demon": demon, "long": long}


def serve(dev, inputs):
    """Phase 4: the serving slice through StreamingRunner; returns launch counts and ms."""
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        MODEL_KEYS, StreamingRunner, load_model, make_dataset, model_config_from_params,
        serving_forward)
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    cfg = load_params_yaml(inputs["params_yaml"])
    config = model_config_from_params(cfg)
    model = load_model(inputs["weights_dir"], dev)
    datasets = {v: make_dataset(data_dir, split, cfg, decode_backend="pil")
                for v, (data_dir, split) in inputs["trees"].items()}

    def serve_all(impl):
        runner = StreamingRunner(model, config, device=dev, impl=impl)
        outs = []
        for v in (1, 2):
            for idepth, names in runner.run(datasets[v], batch_size=1, workers=1):
                outs.append((v, idepth, names))
        return outs

    zero_launches()
    served = serve_all("auto")
    launches = read_launches()
    n_forward = len(served)
    log(f"serving: {n_forward} forwards "
        f"({sum(v == 1 for v, _, _ in served)} at V=1, {sum(v == 2 for v, _, _ in served)} at V=2); "
        f"launches {launches}")
    expected = expected_launches([(1, v) for v, _, _ in served])
    if launches != expected:
        raise AssertionError(f"expected launches {expected}, got {launches}")
    plain = serve_all("plain")
    if read_launches() != launches:
        raise AssertionError("impl='plain' launched a kernel")
    worst = 0.0
    for (v, got, names), (_, ref, _) in zip(served, plain):
        if not (isinstance(got, np.ndarray) and got.shape == (1, H0, W0)
                and np.isfinite(got).all()):
            raise AssertionError(f"bad output for {names}: {type(got)} {got.shape}")
        rng = float(ref.max() - ref.min())
        rel = float(np.abs(got - ref).max()) / rng
        worst = max(worst, rel)
        log(f"serving V={v} {os.path.basename(names[0])}: shape {got.shape}, finite, "
            f"range {rng:.4f}, max|kernel - plain| / range {rel:.3e} (bar {SERVE_BAR:.0e})")
        if not rel <= SERVE_BAR:
            raise AssertionError("serving output disagrees with the plain path")

    # ms per frame at B = 1, V = 1 on one batch already on the card.
    sample = datasets[1][0]
    batch = {"left_image": sample["left_image"], "K": sample["K"],
             "right_images": np.stack(sample["right_images"]),
             "T_right_in_left": np.stack(sample["T_right_in_left"])}
    tensors = {k: torch.as_tensor(np.asarray(batch[k], np.float32)[None]).to(dev)
               for k in MODEL_KEYS}
    with torch.inference_mode():
        ms = {impl: median_ms(lambda: serving_forward(model, tensors, config, impl))
              for impl in ("auto", "plain")}
    return launches, ms, worst, served


def read_table(path):
    """(header, filenames, values (rows, columns)) of a metrics file."""
    with open(path) as f:
        lines = f.read().splitlines()
    header = lines[0].split()
    values = np.array([[float(x) for x in line.split()[1:]] for line in lines[1:]])
    return header, [line.split()[0] for line in lines[1:]], values.reshape(-1, len(header) - 1)


def table_gap(got_path, ref_path):
    """The worst gap of a kernel table against its plain table, as a fraction of its bar
    (<= 1 passes): a1-a3 absolute over 1e-3, every other column relative over 1e-4, NaN
    equal to NaN; the same header and filenames in the same order."""
    header, names, got = read_table(got_path)
    ref_header, ref_names, ref = read_table(ref_path)
    if header != ref_header or names != ref_names or got.shape != ref.shape:
        raise AssertionError(f"{got_path}: header or rows differ from the plain run's")
    worst = 0.0
    for j, key in enumerate(header[1:]):
        if key == "runtime_ms":
            continue
        a, b = got[:, j], ref[:, j]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{got_path} {key}: NaN rows differ")
        ok = ~np.isnan(b)
        if key in RATIOS:
            gap = np.abs(a[ok] - b[ok]) / EVAL_DELTA_BAR
        else:
            gap = np.abs(a[ok] - b[ok]) / (EVAL_REL_BAR * np.abs(b[ok]))
        worst = max([worst] + list(np.nan_to_num(gap, nan=np.inf)))
    return worst


def evaluate(dev, inputs, smi):
    """Phase 5: the eval CLI on the card, kernel and plain paths."""
    from multi_view_stereonet_tpu_torch.eval.test_cli import load_data, run_eval
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    cfg = load_params_yaml(inputs["params_yaml"])
    runs = {"gta_sfm V=1": (*inputs["trees"][1], 2), "DeMoN": (*inputs["demon"], 1)}
    worst = 0.0
    for name, (data_dir, split, batch_size) in runs.items():
        n = len(load_data(data_dir, split, cfg).dataset)
        batches = [min(batch_size, n - i) for i in range(0, n, batch_size)]
        forwards = batches + list(dict.fromkeys(batches))  # each new shape warmed once
        outs = {}
        for impl in ("auto", "plain"):
            out = os.path.join(inputs["root"], f"eval {name} {impl}".replace(" ", "_"))
            zero_launches()
            loss, avg = run_eval(inputs["weights_dir"], data_dir, split, out,
                                 batch_size=batch_size, decode_backend="pil", device=dev,
                                 impl=impl)
            launches = read_launches()
            expected = (expected_launches([(b, 1) for b in forwards]) if impl == "auto"
                        else dict.fromkeys(launches, 0))
            log(f"eval {name} impl={impl}: {n} images at batch {batch_size}, "
                f"{len(forwards)} forwards, launches {launches}, avg loss {loss:.4f}, "
                f"abs_rel {avg['abs_rel']:.4f}")
            if launches != expected:
                raise AssertionError(f"eval {name} impl={impl}: expected launches "
                                     f"{expected}, got {launches}")
            files = sorted(os.listdir(out))
            needed = {"losses.txt", "depth_metrics.txt", "runtime_metrics.txt",
                      "avg_losses.txt", "avg_depth_metrics.txt", "avg_runtime_metrics.txt"}
            if "demon" in split:
                needed |= {f"depth_metrics_{t}.txt" for t in ("mvs", "sun3d", "rgbd",
                                                               "scenes11")}
                needed |= {"avg_depth_metrics_mvs.txt", "avg_depth_metrics_sun3d.txt"}
            if not needed <= set(files) or not np.isfinite(loss):
                raise AssertionError(f"eval {name} impl={impl}: files {files}, loss {loss}")
            outs[impl] = (out, files)
        if outs["auto"][1] != outs["plain"][1]:
            raise AssertionError(f"eval {name}: the kernel and plain runs wrote other files")
        for fname in outs["auto"][1]:
            if fname.endswith(".txt") and not fname.startswith("avg_"):
                gap = table_gap(os.path.join(outs["auto"][0], fname),
                                os.path.join(outs["plain"][0], fname))
                worst = max(worst, gap)
                if not gap <= 1.0:
                    raise AssertionError(f"eval {name} {fname}: kernel rows off the plain "
                                         f"rows by {gap:.3f} of the bar")
    log(f"eval: worst gap of kernel rows to plain rows {worst:.4f} of the bar (a1-a3 "
        f"{EVAL_DELTA_BAR:.0e} absolute, other columns {EVAL_REL_BAR:.0e} relative)")

    data_dir, split = inputs["long"]
    runtimes = {}
    for batch_size in (1, 2):
        out = os.path.join(inputs["root"], f"eval_long_b{batch_size}")
        run_eval(inputs["weights_dir"], data_dir, split, out, batch_size=batch_size,
                 decode_backend="pil", device=dev)
        _, names, values = read_table(os.path.join(out, "runtime_metrics.txt"))
        ms = values[:, 0]
        if len(names) != LONG or not np.isfinite(ms).all():
            raise AssertionError(f"eval over the long tree: {len(names)} rows, {ms}")
        runtimes[batch_size] = float(np.median(ms))
        log(f"eval gta_sfm V=1 B={batch_size}: runtime_ms per image median "
            f"{np.median(ms):.3f}, mean {ms.mean():.3f}, quartiles "
            f"{np.percentile(ms, 25):.3f}-{np.percentile(ms, 75):.3f}, over {LONG} "
            f"480x640 images after one warm-up a batch shape ({smi})")
    return worst, runtimes


def transport(dev, inputs, smi):
    """Phase 6: the u8 transport and the readback on the card."""
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        IN_FLIGHT, StreamingRunner, load_model, make_dataset, model_config_from_params)
    from multi_view_stereonet_tpu_torch.ops.quantize import (
        dequantize_images_u8, dequantize_images_u8_unit)
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    u = np.arange(256, dtype=np.uint8)
    unit = u.astype(np.float32) / 255.0
    full = unit * 2.0 - 1.0
    u_dev = torch.from_numpy(u).to(dev)
    got_full = dequantize_images_u8(u_dev).cpu().numpy()
    got_unit = dequantize_images_u8_unit(u_dev).cpu().numpy()
    naive = (u_dev.float() / 255.0 * 2.0 - 1.0).cpu().numpy()
    log(f"transport: dequantize of all 256 values on the card bit-equal to the host: "
        f"{np.array_equal(got_full.view(np.int32), full.view(np.int32))} (x/255*2-1), "
        f"{np.array_equal(got_unit.view(np.int32), unit.view(np.int32))} (x/255); "
        f"a plain division by 255 on the card differs in "
        f"{int((naive.view(np.int32) != full.view(np.int32)).sum())} of 256")
    if not (np.array_equal(got_full.view(np.int32), full.view(np.int32))
            and np.array_equal(got_unit.view(np.int32), unit.view(np.int32))):
        raise AssertionError("the dequantize on the card is not bit-exact")

    cfg = load_params_yaml(inputs["params_yaml"])
    config = model_config_from_params(cfg)
    model = load_model(inputs["weights_dir"], dev)
    data_dir, split = inputs["trees"][1]
    datasets = {u8: make_dataset(data_dir, split, cfg, "pil", u8_output=u8)
                for u8 in (False, True)}
    n = len(datasets[False])

    def serve_once(batch_size, u8=False, fetch_dtype=None):
        runner = StreamingRunner(model, config, device=dev, fetch_dtype=fetch_dtype)
        outs = [idepth for idepth, _ in runner.run(datasets[u8], batch_size=batch_size)]
        if not all(isinstance(o, np.ndarray) for o in outs):
            raise AssertionError("StreamingRunner.run must yield numpy arrays")
        return np.concatenate(outs)

    zero_launches()
    forwards = []
    for B in (1, 4):
        f32 = serve_once(B)
        u8 = serve_once(B, u8=True)
        f16 = serve_once(B, fetch_dtype=torch.float16)
        forwards += [(min(B, n - i), 1) for i in range(0, n, B)] * 3
        ok_u8 = np.array_equal(u8.view(np.int32), f32.view(np.int32))
        ok_f16 = f16.dtype == np.float16 and np.array_equal(f16, f32.astype(np.float16))
        log(f"transport B={B}: {f32.shape[0]} depthmaps; u8 transport bit-equal to f32: "
            f"{ok_u8}; f16 fetch equal to the f32 output cast: {ok_f16}")
        if not (ok_u8 and ok_f16 and f32.shape == (n, H0, W0) and np.isfinite(f32).all()):
            raise AssertionError(f"transport B={B}: outputs disagree")
    launches = read_launches()
    expected = expected_launches(forwards)
    log(f"transport: launches {launches}")
    if launches != expected:
        raise AssertionError(f"transport: expected launches {expected}, got {launches}")

    # Throughput: one runner a run over the long tree; the steady window leaves out the
    # loader's start-up (the first IN_FLIGHT + 2 results) and the drain (the last
    # IN_FLIGHT, which wait on no new forward).
    long_data = {u8: make_dataset(*inputs["long"], cfg, "pil", u8_output=u8)
                 for u8 in (False, True)}
    rates = {}
    for B in (1, 4):
        for repeat in range(2):
            # The runner's four decode threads, then f32 with one (do they slow the
            # forward's host dispatch?).
            for u8, workers in ((False, 4), (True, 4), (False, 1)):
                runner = StreamingRunner(model, config, device=dev)
                stamps, count = [], 0
                for idepth, names in runner.run(long_data[u8], batch_size=B,
                                                workers=workers):
                    stamps.append(time.perf_counter())
                    count += len(names)
                window = np.array(stamps[IN_FLIGHT + 2:len(stamps) - IN_FLIGHT])
                if count != LONG or len(window) < 8:
                    raise AssertionError(f"transport B={B}: {count} results")
                per_request = float(np.median(np.diff(window))) * 1e3 / B
                rate = B * (len(window) - 1) / float(window[-1] - window[0])
                key = (B, "u8" if u8 else "f32", workers)
                rates.setdefault(key, []).append(rate)
                log(f"transport B={B} {key[1]} workers={workers} run {repeat + 1}: "
                    f"{per_request:.3f} ms a request (median), {rate:.2f} depthmaps/s with "
                    f"the readback over {len(window) - 1} steady steps of {LONG} 480x640 "
                    f"V=1 requests, host decode included ({smi})")
    return rates


def stack_samples(samples):
    """Dataset samples -> one batch of numpy arrays under the model's keys."""
    return {"left_image": np.stack([s["left_image"] for s in samples]),
            "right_images": np.stack([np.stack(s["right_images"]) for s in samples]),
            "K": np.stack([s["K"] for s in samples]).astype(np.float32),
            "T_right_in_left": np.stack([np.stack(s["T_right_in_left"])
                                         for s in samples]).astype(np.float32)}


def conv_flags(module, args) -> dict:
    """Call ``module`` (a loaded artifact) once on ``args`` and return the cuDNN TF32
    flags seen at its convs: {"<kind> <module>": sorted flags}, the kind "aten" for the
    graph's aten convs (seen by a dispatch mode) and "op" for those of
    ``mvs_torch::convolution`` (seen where its body calls ``ops.precision._conv``), the
    module the model's top-level one whose weight the conv takes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from multi_view_stereonet_tpu_torch.ops import precision

    owner = {p.data_ptr(): name.split(".")[1] for name, p in module.named_parameters()}
    seen = {}

    def note(kind, weight):
        seen.setdefault(f"{kind} {owner.get(weight.data_ptr(), 'other')}", set()).add(
            torch.backends.cudnn.allow_tf32)

    # Under inference mode the mode sees conv2d / conv3d whole; otherwise the
    # convolution they decompose to.
    aten = torch.ops.aten
    convs = (aten.convolution, aten.conv2d, aten.conv3d)

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in convs:
                note("aten", args[1])
            return func(*args, **(kwargs or {}))

    conv = precision._conv

    def op_conv(x, weight, *rest):
        note("op", weight)
        return conv(x, weight, *rest)
    precision._conv = op_conv
    try:
        with Spy():
            module(*args)
    finally:
        precision._conv = conv
    return {k: sorted(v) for k, v in sorted(seen.items())}


def artifact_child(path, io_path, device, ambient_tf32=False, spy=False):
    """Phase 9's fresh process: load the artifact at ``path`` (no weights directory, the
    network's modules never imported), run it once on ``device`` on the inputs saved at
    ``io_path`` with cuDNN's TF32 flag set to ``ambient_tf32`` (phase 13) and print one
    JSON line: bit-equality with the live output saved there, the launch counts of that
    run, the custom ops in the graph, whether ``models`` was imported, the precision
    mode the artifact runs at and the TF32 flags after the call; with ``spy``, also the
    flags at each conv of a second call (``conv_flags``)."""
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = ambient_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    from multi_view_stereonet_tpu_torch.checkpoint.export import custom_ops, load_exported

    t0 = time.perf_counter()
    artifact = load_exported(path)
    load_s = time.perf_counter() - t0
    exported = torch.export.load(path)
    constants = sorted(exported.constants.items(), key=lambda kv: -kv[1].nbytes)
    io = np.load(io_path)
    args = [torch.from_numpy(io[k]).to(device) for k in ARTIFACT_KEYS]
    zero_launches()
    zero_tf32_launches()
    with torch.inference_mode():
        out = artifact(*args).cpu().numpy()
    flags_after = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
    launches, launches_tf32 = read_launches(), tf32_launches()
    if spy:
        with torch.inference_mode():
            flags = conv_flags(artifact, args)
    live = io["live"]
    equal = (out.dtype == live.dtype and out.shape == live.shape
             and out.tobytes() == live.tobytes())
    print(json.dumps({"equal": bool(equal), "dtype": str(out.dtype),
                      "launches": launches, "tf32_launches": launches_tf32,
                      "mode": artifact.mvs_precision, "flags_after": flags_after,
                      "ops": custom_ops(artifact), "conv_flags": flags if spy else None,
                      "models_imported": "multi_view_stereonet_tpu_torch.models" in sys.modules,
                      "load_s": load_s,
                      "weights_bytes": sum(t.nbytes for t in exported.state_dict.values()),
                      "constants_bytes": sum(t.nbytes for _, t in constants),
                      "largest_constants": [[k, list(t.shape)] for k, t in constants[:3]]}),
          flush=True)


def host_us(fn, calls=200) -> float:
    """Host time of one call, in microseconds: ``calls`` calls after 20 warm-ups, the
    host clock around the calls alone (the device keeps up: each kernel takes less)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def dispatch_costs(dev, model):
    """Each kernel's call through its custom op (the artifact's route) and to its launch
    code directly (the eager route, no dispatcher), host microseconds at a serving
    shape, in turns op, direct, direct, op; medians. And the launch code's device guard
    alone (``build.launch_device`` where the tensors' card is current, as on every
    eager call): "guard_us", median of three."""
    from multi_view_stereonet_tpu_torch.ops.cuda import build, gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp

    g = torch.Generator().manual_seed(9)

    def rand(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1).to(dev)
    fr = model.right_feature_extractor.refiner
    res = fr.res0
    vec = torch.stack([fr.conv0.bias, fr.bn0.weight, fr.bn0.bias, res.conv1.bias,
                       res.bn1.weight, res.bn1.bias, fr.conv_final.bias])
    pack, dilations = refiner_op.packed_weights(model.refiner4)
    bn = model.left_feature_extractor.res0.bn1
    H_inc = torch.eye(3).repeat(1, D - 1, 1, 1).to(dev)
    cases = {
        "warp": (warp._grid_sample_op, warp._grid_sample_launch,
                 (rand(1, H0, W0, 3), rand(1, H0, W0, 2), True)),
        "chain": (chain._incremental_chain_op, chain._incremental_chain_launch,
                  (rand(1, 30, 40, 32), rand(1, D - 1, 30, 40, 3), H_inc,
                   chain._taps(fr.conv0.weight), chain._taps(res.conv1.weight),
                   chain._taps(fr.conv_final.weight), vec, 0)),
        "refiner": (refiner_op._idepthmap_refiner_op, refiner_op._idepthmap_refiner_launch,
                    (rand(1, 35, 30, 40), rand(1, 30, 40).abs(), pack, list(dilations))),
        "gn_apply": (gn_apply._group_norm_act_op, gn_apply._group_norm_act_launch,
                     (rand(2, 32, 30, 40), bn.weight, bn.bias, rand(2, 32, 30, 40), 4)),
    }
    def guard():
        with build.launch_device(dev):
            pass

    guard_us = statistics.median(host_us(guard) for _ in range(3))
    costs = {}
    with torch.inference_mode():
        for name, (op, launch, args) in cases.items():
            runs = {op: [], launch: []}
            for fn in (op, launch, launch, op):
                runs[fn].append(host_us(lambda: fn(*args)))
            costs[name] = {"op_call_us": statistics.median(runs[op]),
                           "direct_call_us": statistics.median(runs[launch]),
                           "guard_us": guard_us}
    return costs


def artifact_phase(dev, inputs, smi):
    """Phase 9: the weights as the reference's TorchScript archive, and the serving
    artifact (``checkpoint/export.py``) at B = 1 f32 and at B = 24 u8 / f16."""
    from multi_view_stereonet_tpu_torch.checkpoint import export, load_exported
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        StreamingRunner, load_model, make_dataset, model_config_from_params, serving_forward)
    from multi_view_stereonet_tpu_torch.eval.test_cli import run_eval
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    root = inputs["root"]
    pt_run = os.path.join(root, "run_pt")
    pt_dir = os.path.join(pt_run, "checkpoints", "epoch0000")
    os.makedirs(pt_dir)
    with open(inputs["params_yaml"]) as src, open(os.path.join(pt_run, "params.yaml"),
                                                  "w") as dst:
        dst.write(src.read())
    tests_module("reference_archive").write_reference_archive(
        random_state_dict(0), os.path.join(pt_dir, "stereo_network.pt"))
    data_dir, split = inputs["trees"][1]
    outs = {}
    for kind, weights_dir in (("pth", inputs["weights_dir"]), ("pt", pt_dir)):
        outs[kind] = os.path.join(root, f"eval_weights_{kind}")
        run_eval(weights_dir, data_dir, split, outs[kind], decode_backend="pil", device=dev)
    files = sorted(os.listdir(outs["pth"]))
    compared = [f for f in files if "runtime" not in f]
    if sorted(os.listdir(outs["pt"])) != files or not compared:
        raise AssertionError(f"run_eval from .pt wrote other files: {outs}")
    for name in compared:
        texts = [open(os.path.join(outs[k], name)).read() for k in ("pth", "pt")]
        if texts[0] != texts[1]:
            raise AssertionError(f"run_eval from .pt differs from .pth in {name}")
    log(f"weights: run_eval from the reference-layout stereo_network.pt equal to the .pth "
        f"run in {len(compared)} files ({', '.join(compared)})")

    paths = {"b1": os.path.join(root, "serving_b1.pt2"),
             "b24": os.path.join(root, "serving_b24_u8_f16.pt2")}
    export_s = {}
    for name, extra in (("b1", []), ("b24", ["--batch", "24", "--u8", "--fetch",
                                             "float16"])):
        t0 = time.perf_counter()
        export.main([pt_dir, paths[name], "--size", str(H0), str(W0), "--device", str(dev),
                     *extra])
        export_s[name] = time.perf_counter() - t0

    cfg = load_params_yaml(inputs["params_yaml"])
    config = model_config_from_params(cfg)
    model = load_model(inputs["weights_dir"], dev)
    batches = {"b1": stack_samples([make_dataset(data_dir, split, cfg, "pil")[0]])}
    long_u8 = make_dataset(*inputs["long"], cfg, "pil", u8_output=True)
    batches["b24"] = stack_samples([long_u8[i] for i in range(24)])
    fetch = {"b1": None, "b24": torch.float16}
    live = {n: StreamingRunner(model, config, device=dev, fetch_dtype=fetch[n]).forward(
        batches[n]).cpu().numpy() for n in paths}
    expected = {"b1": expected_launches([(1, 1)]), "b24": expected_launches([(24, 1)])}
    all_ops = ["mvs_torch::grid_sample", "mvs_torch::group_norm_act",
               "mvs_torch::idepthmap_refiner", "mvs_torch::incremental_chain"]
    codes = {}
    for name in paths:
        io_path = os.path.join(root, f"artifact_io_{name}.npz")
        np.savez(io_path, live=live[name], **batches[name])
        codes[name] = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
                       f"chip_smoke.artifact_child({paths[name]!r}, {io_path!r}, "
                       f"{str(dev)!r})")
    children = fresh_processes(codes, "artifact")
    for name in paths:
        child = children[name]
        ops = [op for op in all_ops if name == "b1" or "refiner" not in op]
        log(f"artifact {name} ({os.path.getsize(paths[name])} bytes, exported in "
            f"{export_s[name]:.1f} s) in a fresh process: loaded in {child['load_s']:.1f} s, "
            f"{child['dtype']} output bit-equal to the live runner {child['equal']}, "
            f"launches {child['launches']} (expected {expected[name]}), custom ops "
            f"{child['ops']}, network modules imported {child['models_imported']}; "
            f"{child['weights_bytes']} bytes of weights, {child['constants_bytes']} of "
            f"constants, the largest {child['largest_constants']}")
        if not (child["equal"] and child["launches"] == expected[name]
                and child["ops"] == ops and not child["models_imported"]):
            raise AssertionError(f"artifact {name} fails its contract: {child}")

    with torch.inference_mode():
        for name in paths:
            artifact = load_exported(paths[name])
            tensors = [torch.from_numpy(batches[name][k]).to(dev) for k in ARTIFACT_KEYS]
            batch = dict(zip(ARTIFACT_KEYS, tensors))
            calls = {"artifact": lambda: artifact(*tensors),
                     "live": lambda: serving_forward(model, batch, config,
                                                     fetch_dtype=fetch[name])}
            runs = {"artifact": [], "live": []}
            for turn in ("artifact", "live", "live", "artifact"):
                runs[turn].append(median_ms(calls[turn]) / len(tensors[0]))
            log(f"artifact {name}: ms/frame, median of 20 after warm-up, in turns "
                f"artifact {runs['artifact'][0]:.3f}, live {runs['live'][0]:.3f}, live "
                f"{runs['live'][1]:.3f}, artifact {runs['artifact'][1]:.3f} ({smi})")
    costs = dispatch_costs(dev, model)
    for name, c in costs.items():
        log(f"dispatch {name}: a call through its custom op {c['op_call_us']:.1f} us of "
            f"host, to its launch code directly {c['direct_call_us']:.1f} us, of which the "
            f"device guard {c['guard_us']:.3f} us ({smi})")
    return {"launches": {n: c["launches"] for n, c in children.items()},
            "dispatch": costs}


def bf16_ulp(t):
    """One bf16 ulp at each element of ``t`` (bf16 values as f32): 2^(e - 7) for |t| in
    [2^e, 2^(e+1)), the smallest normal's for 0."""
    mag = t.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_kernels_bf16(dev, f32_kernels, failures):
    """Phase 11 (a): each kernel's bf16 variant at phase 3's serving shapes against its
    plain version at bf16, with its device time beside the f32 kernel's (phase 3) and its
    bound at bf16 bytes. A bar missed is appended to ``failures``."""
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        incremental_homographies, normalize_baseline)
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner, IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops import homography_grid
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(11)
    results = {}

    def geometry(n, seed):
        K, T = scene(n, seed)
        T, _ = normalize_baseline(T)
        K_pyr = build_K_pyramid(K, pyramid_sizes(H0, W0, 5))
        return K_pyr, T, create_idepth_samples(T, K_pyr[4], 30, 40, D)

    def entry(err, t, b, bar, f32_name):
        return {"max_abs_err": err, **t, "f32_ms": f32_kernels[f32_name]["ms"],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None, "bar": bar}

    # K1 at the min-idepth warp, f32 image in, bf16 out: bit-equal to the f32 kernel's
    # output rounded (the plain version's too, up to its 1e-5 f32 bar).
    K_pyr, T, samples = geometry(1, 1)
    H_min = create_plane_sweep_homographies(T, K_pyr[0], samples[:, :1])[:, 0]
    image = (torch.rand(1, H0, W0, 3, generator=g) * 2 - 1).to(dev)
    grid = homography_grid(H_min, H0, W0)
    got, inv = warp.grid_sample(image, grid, True, impl="kernel", out_dtype=bf16)
    f32, inv32 = warp.grid_sample(image, grid, True, impl="kernel")
    ref, _ = warp.grid_sample(image, grid, True, impl="plain", out_dtype=bf16)
    equal = got.dtype == bf16 and torch.equal(got, f32.to(bf16)) and torch.equal(inv, inv32)
    err = (got.float() - ref.float()).abs().max().item()
    t = {"ms": graph_ms(lambda: warp.grid_sample(image, grid, True, impl="kernel",
                                                 out_dtype=bf16)),
         "plain_ms": graph_ms(lambda: warp.grid_sample(image, grid, True, impl="plain",
                                                       out_dtype=bf16))}
    b = bound(nbytes(image, grid, got, inv), got.numel() // 3 * (20 + 7 * 3))
    log(f"K1 grid_sample bf16 out (1,480,640,3) min-idepth warp: bit-equal to the f32 "
        f"kernel rounded {equal}; max|kernel - plain at bf16| {err:.3e}; device kernel "
        f"{t['ms']:.4f} ms (f32 out {f32_kernels['warp']['ms']:.4f}), plain "
        f"{t['plain_ms']:.4f} ms; bound {b[0]:.4f} ms ({b[1]})")
    if not equal:
        failures.append("K1's bf16 output is not its f32 output rounded")
    results["warp"] = entry(err, t, b, "bit-equal to the f32 kernel rounded", "warp")

    # K2 at N = 1 and 8, 30x40x32, D = 12: feats0 and the carry bf16.
    refiner = FeatureRefiner(32)
    prefix = "right_feature_extractor.refiner."
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev).eval()
    for n in (1, 8):
        K_pyr, T, samples = geometry(n, 10 + n)
        H_inc = incremental_homographies(create_plane_sweep_homographies(T, K_pyr[4], samples))
        feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev).to(bf16)
        image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)

        def kernel():
            return chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="kernel")

        def plain():
            return chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="plain")
        got, ref = kernel(), plain()
        ref32 = chain.incremental_chain(refiner, feats0.float(), image_rest, H_inc,
                                        impl="plain")
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        err32 = (got.float() - ref32).abs().max().item()
        plain_err32 = (ref.float() - ref32).abs().max().item()
        scale32 = ref32.abs().max().item()
        ok = (got.dtype == bf16 and bool(torch.isfinite(got).all())
              and err <= BF16_CHAIN_BAR * scale and err32 <= BF16_CHAIN_F32_BAR * scale32)
        t = {"ms": graph_ms(kernel), "plain_ms": graph_ms(plain)}
        b = bound(nbytes(feats0, image_rest.to(bf16), H_inc, got, *refiner.parameters()),
                  (D - 1) * (conv_flops(refiner, n * 30 * 40) + 20 * got[:, 0].numel()),
                  PEAK_BF16_FLOPS)
        log(f"K2 incremental_chain bf16 N={n} 30x40x32 D={D}: max_abs_err {err:.3e} "
            f"({err / scale:.4f} of max|plain| {scale:.3f}, bar {BF16_CHAIN_BAR}); against "
            f"the f32 chain {err32 / scale32:.4f} of its max (bar {BF16_CHAIN_F32_BAR}; the "
            f"plain bf16 loop's {plain_err32 / scale32:.4f}), within bars {ok}; device kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound {b[0]:.4f} ms ({b[1]})")
        if not ok:
            failures.append(f"K2 at bf16 off its plain version or the f32 chain at N={n}")
        if n == 1:
            results["chain"] = entry(err, t, b, f"{BF16_CHAIN_BAR} * max|plain|, "
                                     f"{BF16_CHAIN_F32_BAR} * max|f32 plain|", "chain")
        else:
            results["chain"]["max_abs_err"] = max(results["chain"]["max_abs_err"], err)

    # K3 at level 4 (N = 1, 2) and level 3 (N = 1): guidance bf16, idepth f32; the error
    # also against the largest delta, which is what the bf16 path rounds.
    state = random_state_dict(4)
    for n, h, w, name in ((1, 30, 40, "refiner4"), (2, 30, 40, "refiner4"),
                          (1, 60, 80, "refiner3")):
        with torch.inference_mode(False):
            module = IDepthmapRefiner(35)
            module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                    if k.startswith(name + ".")})
            module = module.to(dev).eval()
        guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev).to(bf16)
        idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
        got = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="kernel")
        ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
        scale = ref.abs().max().item()
        delta = (ref - idepth).abs().max().item()
        err = (got - ref).abs().max().item()
        ok = got.dtype == torch.float32 and bool(torch.isfinite(got).all()) and (
            err <= BF16_KERNEL_BAR * scale)
        t = {"ms": graph_ms(lambda: refiner_op.idepthmap_refiner(module, guidance, idepth,
                                                                 impl="kernel")),
             "plain_ms": graph_ms(lambda: refiner_op.idepthmap_refiner(
                 module, guidance, idepth, impl="plain"))}
        b = bound(nbytes(guidance, idepth, got, *module.parameters()),
                  conv_flops(module, n * h * w) + 7 * 10 * 32 * n * h * w, PEAK_BF16_FLOPS)
        log(f"K3 idepthmap_refiner bf16 ({n},35,{h},{w}): max_abs_err {err:.3e}, max|plain| "
            f"{scale:.3f} (bar {BF16_KERNEL_BAR:.0e} * max|plain|), max|delta| {delta:.3f} "
            f"(error {err / max(delta, 1e-30):.3e} of it), within bar {ok}; device kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound {b[0]:.4f} ms ({b[1]})")
        if not ok:
            failures.append(f"K3 at bf16 disagrees with its plain version at ({n},35,{h},{w})")
        if n == 1 and h == 30:
            # The pack is kept per storage dtype: after a bf16 launch the f32 kernel gets
            # the f32 pack, and gives what it gives from a cold cache.
            refiner_op.invalidate_packed_weights(module)
            cold = refiner_op.idepthmap_refiner(module, guidance.float(), idepth, impl="kernel")
            refiner_op.idepthmap_refiner(module, guidance, idepth, impl="kernel")
            after = refiner_op.idepthmap_refiner(module, guidance.float(), idepth,
                                                 impl="kernel")
            log(f"K3 pack after a bf16 launch: the f32 launch equals a cold-cache f32 "
                f"launch {torch.equal(after, cold)}, differs from the bf16 one "
                f"{not torch.equal(got, cold)}")
            if not (torch.equal(after, cold) and not torch.equal(got, cold)):
                failures.append("K3's bf16 pack reached the f32 kernel")
        if name == "refiner3":
            results["refiner"] = entry(max(err, results.get("refiner", {}).get(
                "max_abs_err", 0.0)), t, b, f"{BF16_KERNEL_BAR} * max|plain|", "refiner")
        else:
            results.setdefault("refiner", {"max_abs_err": 0.0})
            results["refiner"]["max_abs_err"] = max(results["refiner"]["max_abs_err"], err)

    # K2 and K3 at bf16 also at phase 15's shapes (96x128, B = 4), which its ladder's
    # bf16 config reaches: the same bars, no times.
    (feats0, image_rest, H_inc), conv_refiners = conv_shape_inputs(dev, g, 31, bf16)
    got = chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="kernel")
    ref = chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="plain")
    ref32 = chain.incremental_chain(refiner, feats0.float(), image_rest, H_inc, impl="plain")
    scale, scale32 = ref.float().abs().max().item(), ref32.abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    err32 = (got.float() - ref32).abs().max().item()
    ok = (got.dtype == bf16 and bool(torch.isfinite(got).all())
          and err <= BF16_CHAIN_BAR * scale and err32 <= BF16_CHAIN_F32_BAR * scale32)
    log(f"K2 incremental_chain bf16 N={CONV_B} {tuple(feats0.shape[1:])} D={D} (phase 15's "
        f"level 4): {err / scale:.4f} of max|plain| (bar {BF16_CHAIN_BAR}), against the f32 "
        f"chain {err32 / scale32:.4f} (bar {BF16_CHAIN_F32_BAR}), within bars {ok}")
    if not ok:
        failures.append(f"K2 at bf16 off its plain version or the f32 chain at N={CONV_B} "
                        f"{tuple(feats0.shape[1:3])}")
    results["chain"]["max_abs_err"] = max(results["chain"]["max_abs_err"], err)
    for name, guidance, idepth in conv_refiners:
        module = refiner_module(state, name, dev)
        got = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="kernel")
        ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        ok = got.dtype == torch.float32 and bool(torch.isfinite(got).all()) and (
            err <= BF16_KERNEL_BAR * scale)
        log(f"K3 idepthmap_refiner bf16 {tuple(guidance.shape)} ({name} at "
            f"{CONV_SIZE[0]}x{CONV_SIZE[1]}): max_abs_err {err:.3e}, max|plain| {scale:.3f} "
            f"(bar {BF16_KERNEL_BAR:.0e} * max|plain|), within bar {ok}")
        if not ok:
            failures.append(f"K3 at bf16 disagrees with its plain version at "
                            f"{tuple(guidance.shape)}")
        results["refiner"]["max_abs_err"] = max(results["refiner"]["max_abs_err"], err)

    # K4 at every GroupNorm shape of the serving forward and of phase 15's step: within
    # one bf16 ulp of the f32 GroupNorm value and one of the plain result at every
    # element, plus the f32 floor (BF16_KERNEL_BAR's note). Where kernel and plain
    # differ, how often each is the bf16 tail of the f64 GroupNorm value.
    weight = state["refiner0.res0.bn1.weight"].to(dev)
    bias = state["refiner0.res0.bn1.bias"].to(dev)
    # At bf16 the conv that writes x leaves its bias to the GroupNorm (xbias).
    xbias = state["refiner0.res0.conv1.bias"].to(dev)
    worst_ulps = worst_err = 0.0
    F = torch.nn.functional
    for shape, residual, what in GN_SHAPES + CONV_GN_SHAPES:
        x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev).to(bf16)
        res = torch.randn(shape, generator=g).to(dev).to(bf16) if residual else None

        def kernel():
            return gn_apply.group_norm_act(x, weight, bias, 4, res, impl="kernel",
                                           xbias=xbias)

        def plain():
            return gn_apply.group_norm_act(x, weight, bias, 4, res, impl="plain",
                                           xbias=xbias)
        got, ref = kernel().float(), plain().float()
        channel = (1, -1) + (1,) * (x.ndim - 2)
        x32 = x.float() + xbias.reshape(channel)
        y = F.group_norm(x32, 4, weight, bias, gn_apply.EPS)
        terms = ((F.group_norm(x32, 4, eps=gn_apply.EPS) * weight.reshape(channel)).abs()
                 + bias.abs().reshape(channel))
        diff = (got - ref).abs()
        bare = diff / (bf16_ulp(y) + bf16_ulp(ref))
        ulps = (diff / (bf16_ulp(y) + bf16_ulp(ref) + GN_F32_FLOOR * terms)).max().item()
        worst_ulps = max(worst_ulps, ulps)
        err = diff.max().item()
        worst_err = max(worst_err, err)
        y64 = F.group_norm(x32.double(), 4, weight.double(), bias.double(), gn_apply.EPS)
        tail = gn_apply.leaky_relu(y64.float().to(bf16))
        exact = (tail if res is None else tail + res).float()
        off = got != ref
        i = int(bare.argmax())
        log(f"K4 group_norm_act bf16 {shape} {'+ res' if residual else 'no res'} ({what}): "
            f"max_abs_err {err:.3e}, worst {ulps:.2f} of (ulp(GroupNorm) + ulp(result) + "
            f"{GN_F32_FLOOR:.0e} * (|x_hat*gamma| + |beta|)) (bar 1); without the floor "
            f"{bare.flatten()[i].item():.2f}, at y {y.flatten()[i].item():.3e} beside terms "
            f"{terms.flatten()[i].item():.3e}; elements off {off.float().mean().item():.2e}, "
            f"of which the bf16 tail of the f64 value: the kernel "
            f"{int((got[off] == exact[off]).sum())}, plain {int((ref[off] == exact[off]).sum())}")
        if not (ulps <= 1.0 and bool(torch.isfinite(got).all())):
            failures.append(f"K4 at bf16 disagrees with its plain version at {shape}")
        if shape == (1, 32, H0, W0) and residual:
            t = {"ms": graph_ms(kernel), "plain_ms": graph_ms(plain)}
            b = bound(nbytes(x, kernel(), weight, bias, xbias, res), 11 * x.numel())
            log(f"K4 bf16 {shape} + res: device kernel {t['ms']:.4f} ms (f32 "
                f"{f32_kernels['gn_apply']['ms']:.4f}), plain {t['plain_ms']:.4f} ms; bound "
                f"{b[0]:.4f} ms ({b[1]})")
            results["gn_apply"] = entry(err, t, b, "ulp(GroupNorm value) + ulp(plain) + "
                                        "2^-21 (|x_hat gamma| + |beta|) per element",
                                        "gn_apply")
    results["gn_apply"].update(max_abs_err=worst_err, worst_ulps=worst_ulps)
    return results


def forward_levels(model, tensors, config, impl="auto"):
    """The serving forward's refined pyramid, level 0 first, metric (each level over the
    baseline, as ``serving_forward`` scales level 0)."""
    from multi_view_stereonet_tpu_torch.models import mvsnet_forward
    from multi_view_stereonet_tpu_torch.train.pipeline import multi_view_unpack_batch

    inputs = multi_view_unpack_batch(tensors, NUM_LEVELS)
    out = mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"],
                         inputs["T_right_in_left"], inputs["right_image_pyr"], config, impl)
    scale = inputs["baseline"][:, None, None]
    return [lvl / scale for lvl in out["left_idepthmap_pyr"]]


def level_deviation(got, ref):
    """Per level: (max, mean) of |got - ref| over ref's range."""
    out = []
    for g, r in zip(got, ref):
        span = (r.max() - r.min()).item()
        d = (g.float() - r).abs()
        out.append((d.max().item() / span, d.mean().item() / span))
    return out


def bf16_phase(dev, inputs, smi, f32_kernels):
    """Phase 11: the bf16 serving forward (compute_dtype bfloat16): (a) each kernel's bf16
    variant against its plain version, (b) the forward against the f32 forward and the
    kernel path against the plain path, with the launches, (c) timings, (d) the eval CLI
    and the exported artifact at bf16."""
    import dataclasses

    import yaml

    from multi_view_stereonet_tpu_torch.checkpoint import export
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        MODEL_KEYS, StreamingRunner, load_model, make_dataset, model_config_from_params)
    from multi_view_stereonet_tpu_torch.eval.test_cli import run_eval
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    failures = []  # bars missed, raised together at the end of the phase
    with torch.inference_mode():
        kernels = check_kernels_bf16(dev, f32_kernels, failures)

    cfg = load_params_yaml(inputs["params_yaml"])
    f32_config = model_config_from_params(cfg)
    config = dataclasses.replace(f32_config, compute_dtype="bfloat16")
    model = load_model(inputs["weights_dir"], dev)
    datasets = {v: make_dataset(data_dir, split, cfg, decode_backend="pil")
                for v, (data_dir, split) in inputs["trees"].items()}

    # (b) Served through StreamingRunner at bf16, launches counted from zero.
    zero_launches()
    served = []
    runner = StreamingRunner(model, config, device=dev)
    for v in (1, 2):
        for idepth, names in runner.run(datasets[v], batch_size=1, workers=1):
            served.append((v, idepth, names))
    launches = read_launches()
    expected = expected_launches([(1, v) for v, _, _ in served])
    log(f"bf16 serving: {len(served)} forwards through StreamingRunner, launches "
        f"{launches} (expected {expected})")
    if launches != expected:
        failures.append(f"bf16 serving: expected launches {expected}, got {launches}")
    for v, got, names in served:
        if not (got.shape == (1, H0, W0) and got.dtype == np.float32
                and np.isfinite(got).all()):
            failures.append(f"bf16 serving {names}: {got.dtype} {got.shape}")

    # Per level against the f32 forward, and the kernel path against the plain path at
    # bf16, on the first request of each tree.
    deviation = {}
    worst_path = 0.0
    with torch.inference_mode():
        for v in (1, 2):
            batch = stack_samples([datasets[v][0]])
            tensors = {k: torch.as_tensor(batch[k]).to(dev) for k in MODEL_KEYS}
            ref = forward_levels(model, tensors, f32_config)
            got = forward_levels(model, tensors, config)
            plain = forward_levels(model, tensors, config, impl="plain")
            dev_levels = level_deviation(got, ref)
            path = [m for m, _ in level_deviation(got, plain)]
            worst_path = max(worst_path, max(path))
            deviation[f"V={v}"] = dev_levels
            log(f"bf16 forward B=1 V={v} {H0}x{W0} D={D} against f32, per level 0-4 "
                f"(max, mean) % of range: "
                + "; ".join(f"L{i} {100 * m:.3f}, {100 * a:.4f}"
                            for i, (m, a) in enumerate(dev_levels))
                + f"; kernel vs plain path at bf16, max % of range per level: "
                + ", ".join(f"{100 * p:.4f}" for p in path))
            if not all(out.dtype == torch.float32 for out in got):
                failures.append("the bf16 forward's outputs are not float32")
            if any(m > BF16_FORWARD_MAX or a > BF16_FORWARD_MEAN for m, a in dev_levels):
                failures.append(f"bf16 forward V={v} off the f32 forward: {dev_levels}")
            if max(path) > BF16_PATH_BAR:
                failures.append(f"bf16 kernel path off the plain path at V={v}: {path}")

    # (c) ms/frame at bf16 and f32 in turns (f32, bf16, bf16, f32) at B = 1 and 8, the
    # device time a forward (torch.profiler), peak memory. Recorded, claimed for nothing.
    timing = {}
    with torch.inference_mode():
        sample = stack_samples([datasets[1][0]])
        for B in (1, 8):
            tensors = {k: torch.as_tensor(np.repeat(sample[k], B, axis=0)).to(dev)
                       for k in MODEL_KEYS}
            configs = {"f32": f32_config, "bf16": config}

            def call(name):
                return lambda: forward_levels(model, tensors, configs[name])
            runs = {"f32": [], "bf16": []}
            for name in ("f32", "bf16", "bf16", "f32"):
                runs[name].append(median_ms(call(name)) / B)
            busy, peak = {}, {}
            for name in ("f32", "bf16"):
                busy[name] = device_ms(call(name))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                call(name)()
                torch.cuda.synchronize()
                peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            timing[f"B={B}"] = {"ms_frame": runs, "device_ms": busy, "peak_gib": peak}
            log(f"bf16 vs f32 forward B={B} V=1 {H0}x{W0} D={D} ({smi}): ms/frame in turns "
                f"f32 {runs['f32'][0]:.3f}, bf16 {runs['bf16'][0]:.3f}, bf16 "
                f"{runs['bf16'][1]:.3f}, f32 {runs['f32'][1]:.3f}; device-busy ms a forward "
                f"f32 {busy['f32']:.3f}, bf16 {busy['bf16']:.3f}; peak memory f32 "
                f"{peak['f32']:.3f} GiB, bf16 {peak['bf16']:.3f} GiB")

    # (d) The eval CLI with compute_dtype bfloat16 in params.yaml, beside f32 on the same
    # weights and tree.
    run_dir = os.path.join(inputs["root"], "run_bf16")
    weights_dir = os.path.join(run_dir, "checkpoints", "epoch0000")
    os.makedirs(weights_dir)
    with open(inputs["params_yaml"]) as f:
        params = yaml.safe_load(f)
    with open(os.path.join(run_dir, "params.yaml"), "w") as f:
        yaml.safe_dump({**params, "compute_dtype": "bfloat16"}, f)
    from multi_view_stereonet_tpu_torch.eval.streaming import WEIGHTS_FILE
    with open(os.path.join(inputs["weights_dir"], WEIGHTS_FILE), "rb") as src, \
            open(os.path.join(weights_dir, WEIGHTS_FILE), "wb") as dst:
        dst.write(src.read())
    data_dir, split = inputs["trees"][1]
    abs_rel = {}
    for name, wdir in (("f32", inputs["weights_dir"]), ("bf16", weights_dir)):
        out = os.path.join(inputs["root"], f"eval_dtype_{name}")
        zero_launches()
        loss, avg = run_eval(wdir, data_dir, split, out, batch_size=1, decode_backend="pil",
                             device=dev)
        files = set(os.listdir(out))
        needed = {"losses.txt", "depth_metrics.txt", "runtime_metrics.txt",
                  "avg_losses.txt", "avg_depth_metrics.txt", "avg_runtime_metrics.txt"}
        if not needed <= files or not np.isfinite(loss):
            failures.append(f"eval at {name}: files {sorted(files)}, loss {loss}")
        abs_rel[name] = avg["abs_rel"]
        log(f"eval CLI gta_sfm V=1 at {name}: loss {loss:.4f}, abs_rel {avg['abs_rel']:.4f}, "
            f"launches {read_launches()}")

    # The artifact: export --dtype bfloat16 at B = 1, served in a fresh process.
    path = os.path.join(inputs["root"], "serving_b1_bf16.pt2")
    export.main([inputs["weights_dir"], path, "--size", str(H0), str(W0), "--device",
                 str(dev), "--dtype", "bfloat16"])
    batch = stack_samples([datasets[1][0]])
    live = StreamingRunner(model, config, device=dev).forward(batch).cpu().numpy()
    io_path = os.path.join(inputs["root"], "artifact_io_bf16.npz")
    np.savez(io_path, live=live, **batch)
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
            f"chip_smoke.artifact_child({path!r}, {io_path!r}, {str(dev)!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the bf16 artifact in a fresh process failed:\n"
                             f"{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = expected_launches([(1, 1)])
    log(f"artifact bf16 B=1 ({os.path.getsize(path)} bytes) in a fresh process: "
        f"{child['dtype']} output bit-equal to the live runner at bf16 {child['equal']}, "
        f"launches {child['launches']} (expected {expected}), custom ops {child['ops']}")
    if not (child["equal"] and child["launches"] == expected and len(child["ops"]) == 4
            and not child["models_imported"]):
        failures.append(f"the bf16 artifact fails its contract: {child}")
    if failures:
        raise AssertionError("phase 11: " + "; ".join(failures))
    return {"kernels": kernels, "launches": launches, "deviation": deviation,
            "path_max": worst_path, "timing": timing, "abs_rel": abs_rel,
            "artifact_launches": child["launches"]}


def bf16_train_phase(dev, inputs, smi, f32_train, backward):
    """Phase 12: training at compute_dtype bfloat16. (a) Each kernel's Function at bf16
    under gradients against plain autograd at bf16 (``check_backward``); (b) the recipe
    through ``train_cli.train`` with validation and a resume under ``remat_refiners``,
    and the two-view recipe; (c) one batch, kernel path against plain path at bf16 and
    with remat against without, and the step's numbers against f32; (d) two processes
    over gloo against one. Every part runs; a bar missed fails the phase at the end.
    ``backward``: (a)'s result, which ``main`` reads early in the process."""
    import dataclasses

    import yaml

    from multi_view_stereonet_tpu_torch.checkpoint import (
        init_params_numpy, native, random_state_dict, state_dict_from_jax_params)
    from multi_view_stereonet_tpu_torch.data.loader import collate
    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.parallel import ShardedDataset
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    failures = []
    bf16 = torch.bfloat16

    # (b) The recipe at bf16 through train(): steps, validation, a checkpoint, a resume.
    root = inputs["root"]
    data_dir, split = inputs["long"]
    cfg = load_params_yaml(None)
    cfg.update({"num_workers": 4, "num_val_images": BF16_VAL_IMAGES, "debug_image_freq": 0,
                "plot_freq": 0, "compute_dtype": "bfloat16"})
    out = os.path.join(root, "train_bf16")
    val_forwards = -(-BF16_VAL_IMAGES // TRAIN_B)
    counts = []
    # The resumed step runs with remat_refiners, whose backward recomputes each refiner
    # through its kernels again.
    for max_steps, epochs, steps, remat in ((BF16_TRAIN_STEPS, 1, BF16_TRAIN_STEPS, False),
                                            (BF16_TRAIN_STEPS + 1, 2, 1, True)):
        zero_launches()
        t0 = time.perf_counter()
        model = train_cli.train(dict(cfg, num_epochs=epochs, remat_refiners=remat), data_dir,
                                split, split, out, max_steps=max_steps, device=dev)
        expected = expected_launches([(TRAIN_B, 1)] * (steps + val_forwards))
        if remat:
            expected = {k: v + steps * remat_launches(TRAIN_B)[k] for k, v in expected.items()}
        counts.append((read_launches(), expected, time.perf_counter() - t0))
    with open(os.path.join(out, "losses.txt")) as f:
        rows = [line.split() for line in f.read().splitlines()[1:]]
    with open(os.path.join(out, "validation.txt")) as f:
        val_rows = [line.split() for line in f.read().splitlines()[1:]]
    state = native.load_train_state(os.path.join(out, "checkpoints"), 1)
    losses = [float(r[3]) for r in rows]
    f32_weights = (all(p.dtype == torch.float32 for p in model.parameters())
                   and all(v.dtype == torch.float32 for v in state["model"].values()))
    log(f"bf16 train: {BF16_TRAIN_STEPS} steps at B={TRAIN_B} V=1 {H0}x{W0} D={D} with "
        f"validation over {BF16_VAL_IMAGES} images in {counts[0][2]:.1f} s, resumed for 1 "
        f"with remat_refiners in {counts[1][2]:.1f} s; launches {[c[0] for c in counts]} (expected "
        f"{[c[1] for c in counts]}); losses by step {[round(x, 4) for x in losses]}; "
        f"validation {val_rows}; state step {state['step']}; weights and checkpoint f32 "
        f"{f32_weights}")
    if not ([int(r[2]) for r in rows] == list(range(1, BF16_TRAIN_STEPS + 2))
            and np.isfinite(losses).all() and len(val_rows) == 2
            and all(np.isfinite(float(x)) for r in val_rows for x in r[1:])
            and state["step"] == BF16_TRAIN_STEPS + 1 and f32_weights
            and all(got == want for got, want, _ in counts)):
        failures.append("bf16 train(): steps, losses, validation, checkpoint or launches")
    del model, state

    # The two-view recipe with every loss at bf16 (no validation: the JAX CLI's cannot
    # run those losses); the losses' K1 samples f32 images and idepth maps.
    tv_out = os.path.join(root, "train_two_view_bf16")
    zero_launches()
    train_cli.train(dict(cfg, num_epochs=1, estimate_right_idepthmap=True, **TWO_VIEW_FACTORS),
                    data_dir, split, "", tv_out, max_steps=BF16_TWO_VIEW_STEPS, device=dev)
    tv_launches, tv_expected = read_launches(), two_view_launches(BF16_TWO_VIEW_STEPS)
    with open(os.path.join(tv_out, "losses.txt")) as f:
        tv_header, *tv_rows = [line.split() for line in f.read().splitlines()]
    tv_values = np.array([[float(x) for x in r[3:]] for r in tv_rows])
    log(f"bf16 two-view train, every loss: {len(tv_rows)} steps, launches {tv_launches} "
        f"(expected {tv_expected}); losses.txt columns {tv_header[3:]}, all finite "
        f"{bool(np.isfinite(tv_values).all())}; losses {tv_values[:, 0].round(4).tolist()}")
    if not (len(tv_rows) == BF16_TWO_VIEW_STEPS and np.isfinite(tv_values).all()
            and {"reconstruction_loss", "left_right_loss"} <= set(tv_header)
            and tv_launches == tv_expected):
        failures.append("bf16 two-view train(): steps, losses or launches")

    # (c) One batch of the recipe: the kernel path against the plain path at bf16, then
    # each path's step at bf16 and f32 in turns.
    dataset = train_cli.make_dataset(cfg, data_dir, split, True, 0, np.random.default_rng(0))
    batch = collate([dataset[i] for i in range(TRAIN_B)])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if not k.endswith("filenames")}
    state0 = random_state_dict(0)

    def fresh(impl, dtype):
        model = MultiViewStereoNet()
        model.load_state_dict(state0)
        model = model.to(dev)
        config, loss_config, _, step = train_cli.build_train_step(
            dict(cfg, compute_dtype=dtype), 12, model, impl)
        return model, config, loss_config, step

    grads, loss_of = {}, {}
    for impl in ("auto", "plain"):
        model, config, loss_config, _ = fresh(impl, "bfloat16")
        zero_launches()
        loss, _ = make_loss_fn(config, loss_config, impl=impl)(model, batch)
        forward = read_launches()
        loss.backward()
        torch.cuda.synchronize()
        expected = (expected_launches([(TRAIN_B, 1)]) if impl == "auto"
                    else dict.fromkeys(forward, 0))
        want = ({**expected_backward(1), "gn_apply": expected["gn_apply"]} if impl == "auto"
                else dict.fromkeys(BACKWARD_KERNELS, 0))
        if not (forward == read_launches() == expected and backward_launches() == want):
            failures.append(f"bf16 step {impl}: forward launches {forward}, after the "
                            f"backward {read_launches()} and backward launches "
                            f"{backward_launches()}, expected {expected} and {want}")
        if loss.dtype != torch.float32 or any(p.grad.dtype != torch.float32
                                              for p in model.parameters()):
            failures.append(f"bf16 step {impl}: loss {loss.dtype}, gradients not all f32")
        loss_of[impl] = loss.item()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
        if impl == "auto":  # and with remat_refiners, the same weights and batch
            step_launches = forward
            model.zero_grad(set_to_none=True)
            loss, _ = make_loss_fn(dataclasses.replace(config, remat_refiners=True),
                                   loss_config)(model, batch)
            loss.backward()
            loss_of["remat"] = loss.item()
            grads["remat"] = {k: p.grad for k, p in model.named_parameters()}
    worst, worst_key, min_cos = compare_gradients(grads)
    flat = {impl: torch.cat([grads[impl][k].flatten() for k in sorted(grads[impl])])
            for impl in grads}
    flat_gap = ((flat["auto"] - flat["plain"]).norm() / flat["plain"].norm()).item()
    loss_gap = abs(loss_of["auto"] - loss_of["plain"]) / abs(loss_of["plain"])
    remat_gap = ((flat["remat"] - flat["auto"]).norm() / flat["auto"].norm()).item()
    remat_loss_gap = abs(loss_of["remat"] - loss_of["auto"]) / abs(loss_of["auto"])
    log(f"bf16 train step with remat_refiners against without (kernel path): loss "
        f"{remat_loss_gap:.2e} relative (bar {LOSS_BAR:.0e}), flat gradient {remat_gap:.3e} "
        f"relative L2 (bar {BF16_TRAIN_GRAD_BAR:.0e})")
    if not (remat_loss_gap <= LOSS_BAR and remat_gap <= BF16_TRAIN_GRAD_BAR):
        failures.append(f"bf16 remat against no remat: loss {remat_loss_gap}, flat {remat_gap}")
    log(f"bf16 train step kernel vs plain path (same weights and batch): launches "
        f"{step_launches} a step, the backward K4's backward kernel only; loss "
        f"{loss_of['auto']:.6f} vs "
        f"{loss_of['plain']:.6f} ({loss_gap:.2e} relative, bar {BF16_TRAIN_LOSS_BAR:.0e}); "
        f"flat gradient {flat_gap:.3e} relative L2 (bar {BF16_TRAIN_GRAD_BAR:.0e}); worst "
        f"leaf {worst:.3e} of max|plain| at {worst_key}, least cosine {min_cos:.6f}")
    if not (np.isfinite(loss_of["auto"]) and loss_gap <= BF16_TRAIN_LOSS_BAR
            and flat_gap <= BF16_TRAIN_GRAD_BAR):
        failures.append(f"bf16 kernel path against plain: loss {loss_gap}, flat {flat_gap}")
    del grads, flat

    steps_by = {f"{impl} {name}": fresh(impl, dtype) for impl in ("auto", "plain")
                for name, dtype in (("f32", "float32"), ("bf16", "bfloat16"))}
    times, peak = time_steps(steps_by, batch, per_round=3)
    ms = {k: statistics.median(t) for k, t in times.items()}
    for k in steps_by:
        log(f"train step {k}, B={TRAIN_B} V=1 {H0}x{W0} D={D}, adam: {ms[k]:.3f} ms a step "
            f"(median of {len(times[k])}, CUDA events, the four in turns; "
            f"{[round(t, 2) for t in times[k]]}), {TRAIN_B * 1e3 / ms[k]:.2f} images/s, "
            f"peak memory {peak[k] / 2**30:.3f} GiB ({smi})")
    busy, k4 = {}, {}
    for k in ("auto f32", "auto bf16"):
        model, _, _, step = steps_by[k]
        busy[k], _, prof = profile_kernels(lambda: step(model, batch), 1)
        k4[k] = group_norm_device_ms(prof)
    module = steps_by["auto bf16"][0].refiner4
    host = []
    for _ in range(10):
        with torch.no_grad():
            module.conv0.bias.add_(0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refiner_op.packed_weights(module, bf16)
        host.append((time.perf_counter() - t0) * 1e3)
    repack_ms = statistics.median(host)
    f32_busy, f32_peak = f32_train["device"]["auto"]["busy_ms"], f32_train["peak_gib"]["auto"]
    log(f"bf16 train step, kernel path: device busy {busy['auto bf16']:.3f} ms a step against "
        f"f32 {busy['auto f32']:.3f} in this call (phase 7: {f32_busy:.3f}); peak "
        f"{peak['auto bf16'] / 2**30:.3f} GiB against f32 {peak['auto f32'] / 2**30:.3f} "
        f"(phase 7: {f32_peak:.3f}); K4's kernels {k4['auto bf16']['k4_forward_ms']:.3f} ms "
        f"forward, {k4['auto bf16']['k4_backward_ms']:.3f} ms backward (f32 "
        f"{k4['auto f32']['k4_forward_ms']:.3f}, {k4['auto f32']['k4_backward_ms']:.3f}); the "
        f"K3 bf16 repack after an update {repack_ms:.3f} ms of host (median of 10, two fused "
        f"refiners a step) ({smi})")
    del steps_by

    # (d) Two processes over gloo at bf16 (the recipe's width, no augmentation, one loader
    # thread), against one process's steps on the concatenated per-process batches.
    mp_cfg = load_params_yaml(None)
    mp_cfg.update({"num_workers": 1, "augment": False, "debug_image_freq": 0, "plot_freq": 0,
                   "print_freq": 1, "num_epochs": 1, "compute_dtype": "bfloat16"})
    mp_out = os.path.join(root, "train_mp_bf16")
    path = os.path.join(root, "train_mp_bf16.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(mp_cfg, f)
    t0 = time.perf_counter()
    spawn({"kind": "train", "argv": ["--config", path, "--data_dir", data_dir,
                                     "--train_split", split, "--output_dir", mp_out,
                                     "--max_steps", str(BF16_MP_STEPS)]}, MP_PROCESSES)
    mp_s = time.perf_counter() - t0
    with open(os.path.join(mp_out, "losses.txt")) as f:
        mp_rows = [line.split() for line in f.read().splitlines()[1:]]
    local = TRAIN_B // MP_PROCESSES
    loaders = []
    for r in range(MP_PROCESSES):
        shard = ShardedDataset(train_cli.make_dataset(mp_cfg, data_dir, split, True, 0,
                                                      np.random.default_rng(mp_cfg["seed"])),
                               r, MP_PROCESSES)
        loaders.append(train_cli.BatchLoader(shard, local, shuffle=mp_cfg["shuffle"],
                                             seed=mp_cfg["seed"], workers=1))
        loaders[-1].set_epoch(0)
    model = MultiViewStereoNet()
    model.load_state_dict(state_dict_from_jax_params(init_params_numpy(mp_cfg["seed"],
                                                                       reference=True)))
    model = model.to(dev).train()
    _, _, _, step = train_cli.build_train_step(mp_cfg, 1, model)
    one = []
    for _, parts in zip(range(BF16_MP_STEPS), zip(*loaders)):
        loss, _ = step(model, {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                               .to(dev) for k in parts[0] if not k.endswith("filenames")})
        one.append(loss.item())
    two = [float(r[3]) for r in mp_rows]
    mp_gaps = [abs(a - b) / abs(b) for a, b in zip(two, one)]
    log(f"bf16 two processes (gloo, one card), the train CLI at B={TRAIN_B} ({local} a "
        f"process) {H0}x{W0} D={D}, adam, no augmentation: {BF16_MP_STEPS} steps in "
        f"{mp_s:.1f} s (start-up included); losses {two} against one process's {one} on the "
        f"concatenated batches, relative gap by step {[f'{g:.2e}' for g in mp_gaps]} (step 1, "
        f"from the init, bar {BF16_MP_BAR:.0e}; step 2, after adam's first update, "
        f"{DRIFT_BAR:.0e})")
    if not (len(two) == BF16_MP_STEPS and np.isfinite(two).all()
            and mp_gaps[0] <= BF16_MP_BAR and max(mp_gaps[1:]) <= DRIFT_BAR):
        failures.append(f"bf16 two processes against one: {mp_gaps}")
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))
    return {"backward": backward, "launches": step_launches, "ms": ms,
            "images_s": {k: TRAIN_B * 1e3 / v for k, v in ms.items()},
            "peak_gib": {k: v / 2**30 for k, v in peak.items()}, "busy_ms": busy,
            "k4_ms": {k: {kk: v[kk] for kk in ("k4_forward_ms", "k4_backward_ms")}
                      for k, v in k4.items()},
            "repack_host_ms": repack_ms, "loss_gap": loss_gap, "grad_gap": flat_gap,
            "mp_gaps": mp_gaps}


def bound_tf32(read_write_bytes, conv_ops, other_ops):
    """``bound`` of a 1xTF32 kernel: its convs' operations at the TF32 tensor-core peak,
    the rest at f32's, against its bytes."""
    by_bytes = read_write_bytes / PEAK_BYTES_S * 1e3
    by_ops = (conv_ops / PEAK_TF32_FLOPS + other_ops / PEAK_F32_FLOPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_kernels_tf32(dev, failures):
    """Phase 13 (a): K2's and K3's 1xTF32 variants at phase 3's serving shapes against
    their TF32-rounding plain versions, each one's error against the f32 (3xTF32) kernel,
    the device times (``graph_ms``) of both kernels and of the plain version in this
    call, and the bound at TF32. After a 1xTF32 launch the 3xTF32 kernel must give what
    it gave before it (K3 keeps a weight pack a variant)."""
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        incremental_homographies, normalize_baseline)
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner, IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    g = torch.Generator().manual_seed(13)
    results = {}

    def measure(name, shape, tf32, f32, plain, scale_bar, b, keep):
        exact = f32()
        got, ref = tf32(), plain()
        again = f32()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        err_f32 = (got - exact).abs().max().item()
        t = {"ms": graph_ms(tf32), "f32_ms": graph_ms(f32)}
        if keep:
            t["plain_ms"] = graph_ms(plain)
        ok = (bool(torch.isfinite(got).all()) and err <= scale_bar * scale
              and torch.equal(again, exact))
        log(f"{name} 1xTF32 {shape}: max_abs_err {err:.3e} against its TF32-rounding plain "
            f"version, max|plain| {scale:.3f} (bar {scale_bar:.0e}*max|plain|), within bar "
            f"{ok}; against the 3xTF32 kernel {err_f32:.3e} ({err_f32 / scale:.3e} of "
            f"max|plain|); the 3xTF32 kernel unchanged after it {torch.equal(again, exact)}; "
            f"device: 1xTF32 {t['ms']:.4f} ms, 3xTF32 {t['f32_ms']:.4f} ms"
            + (f", plain TF32 {t['plain_ms']:.4f} ms" if keep else "")
            + f"; bound at TF32 {b[0]:.4f} ms ({b[1]})")
        if not ok:
            failures.append(f"{name} 1xTF32 at {shape}: {err} of {scale}")
        return err, err_f32 / scale, t

    refiner = FeatureRefiner(32)
    prefix = "right_feature_extractor.refiner."
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev).eval()
    results["chain"] = {"max_abs_err": 0.0, "err_vs_f32": 0.0, "bar": TF32_K2_BAR}
    for n in (1, 5, 8):
        K, T = scene(n, 10 + n)
        T, _ = normalize_baseline(T)
        K4 = build_K_pyramid(K, pyramid_sizes(H0, W0, 5))[4]
        H_inc = incremental_homographies(create_plane_sweep_homographies(
            T, K4, create_idepth_samples(T, K4, 30, 40, D)))
        feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev)
        image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)
        out = torch.empty(n, D, 30, 40, 32)
        b = bound_tf32(nbytes(feats0, image_rest, H_inc, out, *refiner.parameters()),
                       (D - 1) * conv_flops(refiner, n * 30 * 40),
                       (D - 1) * 20 * n * 30 * 40 * 32)
        err, rel, t = measure(
            "K2 incremental_chain", f"N={n} 30x40x32 D={D}",
            lambda: chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc,
                                                   tf32=True),
            lambda: chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc),
            lambda: chain.incremental_chain_tf32_plain(refiner, feats0, image_rest, H_inc),
            TF32_K2_BAR, b, n == 1)
        entry = results["chain"]
        entry.update(max_abs_err=max(entry["max_abs_err"], err),
                     err_vs_f32=max(entry["err_vs_f32"], rel))
        if n == 1:
            entry.update(**t, bound_ms=b[0], bound_by=b[1], library_ms=None)

    state = random_state_dict(4)
    results["refiner"] = {"max_abs_err": 0.0, "err_vs_f32": 0.0, "bar": TF32_K3_BAR,
                          "library_ms": None}
    for n, h, w, name in ((1, 30, 40, "refiner4"), (2, 30, 40, "refiner4"),
                          (5, 30, 40, "refiner4"), (8, 30, 40, "refiner4"),
                          (1, 60, 80, "refiner3")):
        with torch.inference_mode(False):  # parameters with version counters, as served
            module = IDepthmapRefiner(35)
            module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                    if k.startswith(name + ".")})
            module = module.to(dev).eval()
        guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev)
        idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
        b = bound_tf32(nbytes(guidance, idepth, idepth, *module.parameters()),
                       conv_flops(module, n * h * w), 7 * 10 * 32 * n * h * w)
        keep = (n, h) == (1, 60)
        err, rel, t = measure(
            "K3 idepthmap_refiner", f"({n},35,{h},{w})",
            lambda: refiner_op.idepthmap_refiner_kernel(module, guidance, idepth, tf32=True),
            lambda: refiner_op.idepthmap_refiner_kernel(module, guidance, idepth),
            lambda: refiner_op.idepthmap_refiner_tf32_plain(module, guidance, idepth),
            TF32_K3_BAR, b, keep)
        entry = results["refiner"]
        entry.update(max_abs_err=max(entry["max_abs_err"], err),
                     err_vs_f32=max(entry["err_vs_f32"], rel))
        if keep:  # the level-3 times, where it does the most work, as phase 3 keeps
            entry.update(**t, bound_ms=b[0], bound_by=b[1])

    # Both also at phase 15's shapes (96x128, B = 4), which its ladder's "high" config
    # reaches: the same bars.
    (feats0, image_rest, H_inc), conv_refiners = conv_shape_inputs(dev, g, 32)
    n, h4, w4 = feats0.shape[:3]
    b = bound_tf32(nbytes(feats0, image_rest, H_inc, torch.empty(n, D, h4, w4, 32),
                          *refiner.parameters()),
                   (D - 1) * conv_flops(refiner, n * h4 * w4), (D - 1) * 20 * n * h4 * w4 * 32)
    err, rel, _ = measure(
        "K2 incremental_chain", f"N={n} {h4}x{w4}x32 D={D} (phase 15's level 4)",
        lambda: chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc, tf32=True),
        lambda: chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc),
        lambda: chain.incremental_chain_tf32_plain(refiner, feats0, image_rest, H_inc),
        TF32_K2_BAR, b, False)
    results["chain"].update(max_abs_err=max(results["chain"]["max_abs_err"], err),
                            err_vs_f32=max(results["chain"]["err_vs_f32"], rel))
    for name, guidance, idepth in conv_refiners:
        module = refiner_module(state, name, dev)
        n, _, h, w = guidance.shape
        b = bound_tf32(nbytes(guidance, idepth, idepth, *module.parameters()),
                       conv_flops(module, n * h * w), 7 * 10 * 32 * n * h * w)
        err, rel, _ = measure(
            "K3 idepthmap_refiner", f"({n},35,{h},{w}) ({name} at phase 15's size)",
            lambda: refiner_op.idepthmap_refiner_kernel(module, guidance, idepth, tf32=True),
            lambda: refiner_op.idepthmap_refiner_kernel(module, guidance, idepth),
            lambda: refiner_op.idepthmap_refiner_tf32_plain(module, guidance, idepth),
            TF32_K3_BAR, b, False)
        results["refiner"].update(max_abs_err=max(results["refiner"]["max_abs_err"], err),
                                  err_vs_f32=max(results["refiner"]["err_vs_f32"], rel))
    return results


def check_backward_tf32(dev, failures):
    """Phase 13 (a), K2's backward at 1xTF32 (the backward of the 1xTF32 forward, the
    "tf32" scope's) at phase 3b's shapes: the Function's gradients of feats0 and the
    weights against plain autograd through the TF32-rounding plain loop
    (``incremental_chain_tf32_plain``) by ``chain_legs``' tf32 bars, two backward launches
    and no forward launch in the backward; the backward alone (both launches) against its
    closed form at TF32 on what its forward kept, and its weight-gradient pass alone
    against its plain version on the maps the sequential part kept, within TF32_K2_BAR of
    max|plain|; the device
    times (CUDA graphs) of the 1xTF32 and the 3xTF32 backward kernels and of the closed
    form, and the bound at TF32. Returns the N = 1 entry."""
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        incremental_homographies, normalize_baseline)
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner
    from multi_view_stereonet_tpu_torch.ops import precision
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    g = torch.Generator().manual_seed(14)
    refiner = FeatureRefiner(32)
    prefix = "right_feature_extractor.refiner."
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev)
    params = list(refiner.parameters())
    weights = chain._weight_args(refiner)
    result = None
    for n in (1, 8):
        K, T = scene(n, 10 + n)
        T, _ = normalize_baseline(T)
        K4 = build_K_pyramid(K, pyramid_sizes(H0, W0, 5))[4]
        H_inc = incremental_homographies(create_plane_sweep_homographies(
            T, K4, create_idepth_samples(T, K4, 30, 40, D)))
        feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev).requires_grad_()
        image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)
        cot = torch.randn(n, D, 30, 40, 32, generator=g).to(dev)
        with precision.scope("tf32"):
            out = chain.incremental_chain(refiner, feats0, image_rest, H_inc)
        before, bwd_before = read_launches(), backward_launches()
        got = torch.autograd.grad(out, (feats0, *params), cot)
        torch.cuda.synchronize()
        forward_in_backward = read_launches() != before
        bwd = {k: v - bwd_before[k] for k, v in backward_launches().items()}
        plain = chain.incremental_chain_tf32_plain(refiner, feats0, image_rest, H_inc)
        ref = torch.autograd.grad(plain, (feats0, *params), cot)
        err = worst_relative(got, ref)
        split = chain_legs(refiner, feats0, image_rest, H_inc, cot, got, ref, tf32=True)
        with torch.no_grad():
            f0 = feats0.detach()
            kept = chain._forward_launch(f0, image_rest, H_inc, *weights, 0, True, True)
            kept3 = chain._forward_launch(f0, image_rest, H_inc, *weights, 0, False, True)

            def kernel(tf32=True):
                saved = kept if tf32 else kept3
                return chain._launch_backward(refiner, image_rest, H_inc, weights, *saved,
                                              cot, (True, False, False), 0, tf32)

            def closed():
                return chain.incremental_chain_backward_plain(
                    refiner, f0, image_rest, H_inc, *kept, cot, (True, False, False, True),
                    tf32=True)
            a, r = kernel(), closed()
            err_alone = worst_relative([a[0], *a[3]], [r[0], *r[3]])
            t = {"ms": graph_ms(kernel), "f32_ms": graph_ms(lambda: kernel(False)),
                 "plain_ms": graph_ms(closed)}
            # The weight-gradient pass alone at TF32 on the maps the sequential part kept.
            seq = chain.incremental_chain_sequential(image_rest, H_inc, *weights, *kept, cot,
                                                     (True, False, False), 0, True)

            def wgrad():
                return chain.incremental_chain_wgrad(image_rest, H_inc, weights[3], *kept,
                                                     *seq[3:], True)
            err_wgrad = worst_relative(
                chain._param_grads(refiner, wgrad()),
                chain.incremental_chain_wgrad_plain(refiner, image_rest, H_inc, *kept,
                                                    *seq[3:5], seq[5].sum(0), True))
            t["wgrad_ms"] = graph_ms(wgrad)
        conv_ops = (D - 1) * (conv_flops(refiner, n * 30 * 40) + 2 * n * 30 * 40 * 32 * 288 * 3)
        b = bound_tf32(nbytes(*kept, cot, image_rest, H_inc, *weights, f0, *params), conv_ops,
                       (D - 1) * 40 * n * 30 * 40 * 32)
        ok = (not split["missed"] and err_alone <= TF32_K2_BAR and err_wgrad <= TF32_K2_BAR
              and not forward_in_backward
              and bwd == {"warp": 0, "chain": 2, "refiner": 0, "gn_apply": 0})
        log(f"K2 1xTF32 backward N={n} 30x40x32 D={D}: the Function against plain autograd "
            f"through the TF32-rounding loop {err:.3e} of max|plain|, "
            f"{describe_legs(split)}; the kernel alone against its closed form at TF32 "
            f"{err_alone:.3e} (bar {TF32_K2_BAR:.0e}), its weight-gradient pass alone "
            f"against its plain version {err_wgrad:.3e} ({t['wgrad_ms']:.4f} ms); "
            f"backward launches {bwd}, forward launches in the backward "
            f"{forward_in_backward}; device: 1xTF32 kernel {t['ms']:.4f} ms, 3xTF32 "
            f"{t['f32_ms']:.4f} ms, closed form {t['plain_ms']:.4f} ms; bound at TF32 "
            f"{b[0]:.4f} ms ({b[1]})")
        if not ok:
            failures.append(f"K2 1xTF32 backward at N={n}: missed {split['missed']}, "
                            f"{err_alone}, {err_wgrad}, {bwd}")
        if result is None:
            result = {"max_rel_err": err, "kernel_vs_closed_form": err_alone,
                      "wgrad_vs_plain": err_wgrad, **t, "bound_ms": b[0], "bound_by": b[1],
                      "bar": TF32_K2_BAR, "legs": [split], "n8": None}
        else:
            result["max_rel_err"] = max(result["max_rel_err"], err)
            result["kernel_vs_closed_form"] = max(result["kernel_vs_closed_form"], err_alone)
            result["wgrad_vs_plain"] = max(result["wgrad_vs_plain"], err_wgrad)
            result["legs"].append(split)
            result["n8"] = {**t, "bound_ms": b[0]}
    return result


def check_refiner_backward_tf32(dev, failures):
    """Phase 13 (a), K3's backward at 1xTF32 at level 4 (N = 1, 8) and level 3 (N = 1): the
    Function's gradients (its forward in a "tf32" scope) against plain autograd through
    the TF32-rounding plain version (``idepthmap_refiner_tf32_plain``) by
    ``refiner_legs``' tf32 bars, two backward launches and no forward launch in the
    backward; the backward alone (both launches) against its closed form at TF32 on what
    its forward kept, and its weight-gradient pass alone against its plain version on the
    maps the sequential part kept, within TF32_K2_BAR of max|plain|; the device times (CUDA graphs) of the
    1xTF32 and the 3xTF32 backward kernels and of the closed form, and the bound at TF32.
    Returns the N = 1 level-4 entry, with every shape's readings."""
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.ops import precision
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

    g = torch.Generator().manual_seed(15)
    state = random_state_dict(4)
    result = None
    for n, h, w, name in ((1, 30, 40, "refiner4"), (8, 30, 40, "refiner4"),
                          (1, 60, 80, "refiner3")):
        module = refiner_module(state, name, dev)
        params = list(module.parameters())
        guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev).requires_grad_()
        idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev).requires_grad_()
        cot = torch.randn(n, h, w, generator=g).to(dev)
        inputs = (guidance, idepth, *params)
        with precision.scope("tf32"):
            out = refiner_op.idepthmap_refiner(module, guidance, idepth)
        before, bwd_before = read_launches(), backward_launches()
        got = torch.autograd.grad(out, inputs, cot)
        torch.cuda.synchronize()
        forward_in_backward = read_launches() != before
        bwd = {k: v - bwd_before[k] for k, v in backward_launches().items()}
        ref = torch.autograd.grad(
            refiner_op.idepthmap_refiner_tf32_plain(module, guidance, idepth), inputs, cot)
        err = worst_relative(got, ref)
        split = refiner_legs(module, guidance, idepth, cot, got, ref, tf32=True)
        with torch.no_grad():
            g0, i0 = guidance.detach(), idepth.detach()
            kept = refiner_op._launch(module, g0, i0, True, keep=True)
            kept3 = refiner_op._launch(module, g0, i0, False, keep=True)
            needs = (True, True, True)

            def kernel(tf32=True):
                out, saved = kept if tf32 else kept3
                return refiner_op._launch_backward(module, g0, i0, out, saved, cot, needs,
                                                   tf32)

            def closed():
                return refiner_op.idepthmap_refiner_backward_plain(
                    module, g0, i0, kept[0], *kept[1][:2], cot, needs, tf32=True)
            a, r = kernel(), closed()
            err_alone = worst_relative([a[0], a[1], *a[2]], [r[0], r[1], *r[2]])
            t = {"ms": graph_ms(kernel), "f32_ms": graph_ms(lambda: kernel(False)),
                 "plain_ms": graph_ms(closed)}
            # The weight-gradient pass alone at TF32 on the maps the sequential part kept.
            out1, (raw1, stats1, hs1, pack1) = kept
            dil = refiner_op._dilations(module)
            seq = refiner_op.idepthmap_refiner_sequential(g0, i0, pack1, dil, out1, raw1,
                                                          stats1, hs1, cot, True, True)

            def wgrad():
                return refiner_op.idepthmap_refiner_wgrad(g0, i0, dil, hs1, *seq[2:], True)
            err_wgrad = worst_relative(
                refiner_op._unpack_grads(module, wgrad()),
                refiner_op.idepthmap_refiner_wgrad_plain(module, g0, i0, raw1, stats1, seq[2],
                                                         seq[3], seq[4].sum(0).float(), True))
            t["wgrad_ms"] = graph_ms(wgrad)
        b = bound_tf32(2 * nbytes(g0, i0, *params) + nbytes(kept[0], *kept[1][:3], cot),
                       2 * conv_flops(module, n * h * w),
                       40 * refiner_op.NUM_GN * n * h * w * 32)
        ok = (not split["missed"] and err_alone <= TF32_K2_BAR and err_wgrad <= TF32_K2_BAR
              and not forward_in_backward
              and bwd == {"warp": 0, "chain": 0, "refiner": 2, "gn_apply": 0})
        what = f"({n},35,{h},{w})"
        log(f"K3 1xTF32 backward {what}: the Function against plain autograd through the "
            f"TF32-rounding plain version {err:.3e} of max|plain|, {describe_legs(split)}; the "
            f"kernel alone against its closed form at TF32 {err_alone:.3e} (bar "
            f"{TF32_K2_BAR:.0e}), its weight-gradient pass alone against its plain version "
            f"{err_wgrad:.3e} ({t['wgrad_ms']:.4f} ms); backward launches {bwd}, forward launches in the backward "
            f"{forward_in_backward}; device: 1xTF32 kernel {t['ms']:.4f} ms, 3xTF32 "
            f"{t['f32_ms']:.4f} ms, closed form {t['plain_ms']:.4f} ms; bound at TF32 "
            f"{b[0]:.4f} ms ({b[1]})")
        if not ok:
            failures.append(f"K3 1xTF32 backward at {what}: missed {split['missed']}, "
                            f"{err_alone}, {err_wgrad}, {bwd}")
        shape = {"shape": what, "max_rel_err": err, "kernel_vs_closed_form": err_alone,
                 "wgrad_vs_plain": err_wgrad, **t, "bound_ms": b[0], "bound_by": b[1],
                 "legs": split}
        if result is None:
            result = {**shape, "bar": TF32_K2_BAR, "shapes": []}
        result["max_rel_err"] = max(result["max_rel_err"], err)
        result["kernel_vs_closed_form"] = max(result["kernel_vs_closed_form"], err_alone)
        result["wgrad_vs_plain"] = max(result["wgrad_vs_plain"], err_wgrad)
        result["shapes"].append(shape)
    return result


def tf32_launches():
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    return {"chain": chain.tf32_launches, "refiner": refiner_op.tf32_launches}


def zero_tf32_launches():
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    chain.tf32_launches = refiner_op.tf32_launches = 0


class ConvSpy:
    """Records, at every conv the port runs (``ops.precision``'s forward and backward
    calls), (kind, depthwise, cuDNN TF32 flag, cuBLAS TF32 flag); the losses' blurs are
    the only depthwise (grouped) convs."""

    def __init__(self):
        from multi_view_stereonet_tpu_torch.ops import precision
        self.precision, self.calls = precision, []
        self.saved = (precision._conv, precision._conv_backward)

    def _record(self, kind, groups):
        self.calls.append((kind, groups > 1, torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32))

    def __enter__(self):
        conv, backward = self.saved

        def conv_spy(x, weight, bias, stride, padding, dilation, groups):
            self._record("forward", groups)
            return conv(x, weight, bias, stride, padding, dilation, groups)

        def backward_spy(grad, x, weight, bias_shape, stride, padding, dilation, groups,
                         mask):
            self._record("backward", groups)
            return backward(grad, x, weight, bias_shape, stride, padding, dilation, groups,
                            mask)
        self.precision._conv, self.precision._conv_backward = conv_spy, backward_spy
        return self

    def __exit__(self, *exc):
        self.precision._conv, self.precision._conv_backward = self.saved
        return False

    def summary(self):
        """{(kind, "loss" or "model"): set of (cuDNN flag, cuBLAS flag) seen}."""
        out = {}
        for kind, depthwise, cudnn, cublas in self.calls:
            out.setdefault((kind, "loss" if depthwise else "model"), set()).add((cudnn, cublas))
        return out


def fft_share(prof):
    """(device ms, kernel count) of the cuDNN FFT kernels (a name holding "fft") in a
    profile."""
    from torch.autograd import DeviceType
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "fft" in e.name.lower()]
    return sum(times) / 1e3, len(times)


def precision_phase(dev, inputs, smi, served):
    """Phase 13: the matmul-precision ladder. (a) K2's and K3's 1xTF32 variants against
    their TF32-rounding plain versions; (b) the forward at "high" against "highest" per
    level, the kernel path against the plain path at "high", each stage override alone,
    launches, and the timings in turns; (c) at "default" and "highest" the output bit-equal
    whatever the caller's cuDNN TF32 flag, and to phase 4's, and the flag restored; (d)
    training at "high": kernel path against plain path, a spy on every conv's flags, the
    step against "highest" in turns, cuDNN's FFT weight-gradient kernels, and
    ``train()`` with ``matmul_precision: high``; (e) the artifact exported at "high" and at
    "highest", each run in a fresh process whose flag is the other way. ``served``: phase
    4's outputs. Every part runs; a bar missed fails the phase at the end."""
    import dataclasses

    from multi_view_stereonet_tpu_torch.checkpoint import export, native, random_state_dict
    from multi_view_stereonet_tpu_torch.data.loader import collate
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        MODEL_KEYS, StreamingRunner, load_model, make_dataset, model_config_from_params)
    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.models.mvsnet import STAGES
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    failures = []
    with torch.inference_mode():
        kernels = check_kernels_tf32(dev, failures)
    kernels["chain_backward"] = check_backward_tf32(dev, failures)
    kernels["refiner_backward"] = check_refiner_backward_tf32(dev, failures)

    cfg = load_params_yaml(inputs["params_yaml"])
    base = model_config_from_params(cfg)
    configs = {p: dataclasses.replace(base, matmul_precision=p)
               for p in ("default", "high", "highest")}
    model = load_model(inputs["weights_dir"], dev)
    data_dir, split = inputs["trees"][1]
    dataset = make_dataset(data_dir, split, cfg, decode_backend="pil")
    sample = stack_samples([dataset[0]])

    # (b) The forward at "high" against "highest", per level; launches at "high".
    deviation, timing = {}, {}
    with torch.inference_mode():
        tensors = {k: torch.as_tensor(sample[k]).to(dev) for k in MODEL_KEYS}
        ref = forward_levels(model, tensors, configs["highest"])
        zero_launches()
        zero_tf32_launches()
        got = forward_levels(model, tensors, configs["high"])
        launches, launches_tf32 = read_launches(), tf32_launches()
        plain = forward_levels(model, tensors, configs["high"], impl="plain")
        expected = expected_launches([(1, 1)])
        log(f"forward at high B=1 V=1: launches {launches} (expected {expected}), of them "
            f"1xTF32 {launches_tf32} (expected chain 1, refiner 2)")
        if launches != expected or launches_tf32 != {"chain": 1, "refiner": 2}:
            failures.append(f"launches at high: {launches}, 1xTF32 {launches_tf32}")
        path = [m for m, _ in level_deviation(got, plain)]
        deviation["B=1"] = level_deviation(got, ref)
        log(f"forward at high B=1 V=1 {H0}x{W0} D={D} against highest, per level 0-4 (max, "
            f"mean) % of range: " + "; ".join(f"L{i} {100 * m:.3f}, {100 * a:.4f}"
                                              for i, (m, a) in enumerate(deviation["B=1"]))
            + "; kernel vs plain path at high, max % of range per level: "
            + ", ".join(f"{100 * p:.4f}" for p in path)
            + f" (bar {100 * TF32_PATH_BAR:.1f})")
        if max(path) > TF32_PATH_BAR:
            failures.append(f"kernel path off the plain path at high: {path}")
        tensors8 = {k: torch.as_tensor(np.repeat(sample[k], TRAIN_B, axis=0)).to(dev)
                    for k in MODEL_KEYS}
        deviation[f"B={TRAIN_B}"] = level_deviation(
            forward_levels(model, tensors8, configs["high"]),
            forward_levels(model, tensors8, configs["highest"]))
        log(f"forward at high B={TRAIN_B} V=1 against highest, per level (max, mean) % of "
            "range: " + "; ".join(f"L{i} {100 * m:.3f}, {100 * a:.4f}" for i, (m, a)
                                  in enumerate(deviation[f"B={TRAIN_B}"])))
        for key, levels in deviation.items():
            if any(m > TF32_FORWARD_MAX or a > TF32_FORWARD_MEAN for m, a in levels):
                failures.append(f"forward at high {key} off highest: {levels}")

        # Each stage alone at "high" over "highest": the deviation it brings, and which
        # 1xTF32 kernel it launches.
        stages = {}
        for stage in STAGES:
            config = dataclasses.replace(configs["highest"],
                                         stage_precision=((stage, "high"),))
            zero_tf32_launches()
            levels = level_deviation(forward_levels(model, tensors, config), ref)
            stages[stage] = levels
            want = {"chain": int(stage == "chain"), "refiner": 2 * (stage == "refiners")}
            log(f"stage {stage} alone at high (the rest highest) B=1: per level max % of "
                f"range " + ", ".join(f"{100 * m:.4f}" for m, _ in levels)
                + f"; 1xTF32 launches {tf32_launches()} (expected {want})")
            if tf32_launches() != want or (stage == "warp" and max(m for m, _ in levels)):
                failures.append(f"stage {stage} at high: launches {tf32_launches()}, "
                                f"levels {levels}")

        # ms/frame at "high" and "highest" in turns, device busy a forward, peak memory.
        for B, batch in ((1, tensors), (TRAIN_B, tensors8)):
            def call(name):
                return lambda: forward_levels(model, batch, configs[name])
            runs = {"highest": [], "high": []}
            for name in ("highest", "high", "high", "highest"):
                runs[name].append(median_ms(call(name)) / B)
            busy, peak = {}, {}
            for name in ("highest", "high"):
                busy[name] = device_ms(call(name))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                call(name)()
                torch.cuda.synchronize()
                peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            timing[f"B={B}"] = {"ms_frame": runs, "device_ms": busy, "peak_gib": peak}
            log(f"forward high vs highest B={B} V=1 {H0}x{W0} D={D} ({smi}): ms/frame in "
                f"turns highest {runs['highest'][0]:.3f}, high {runs['high'][0]:.3f}, high "
                f"{runs['high'][1]:.3f}, highest {runs['highest'][1]:.3f}; device-busy ms a "
                f"forward highest {busy['highest']:.3f}, high {busy['high']:.3f}; peak "
                f"memory highest {peak['highest']:.3f} GiB, high {peak['high']:.3f} GiB")

    # (c) The config decides: at "default" and "highest" the runner's output is bit-equal
    # whatever the caller's cuDNN TF32 flag, and to phase 4's; the flag is the caller's
    # again after the call.
    phase4 = next(out for v, out, _ in served if v == 1)
    for name in ("default", "highest"):
        outs, after = {}, {}
        for ambient in (True, False):
            torch.backends.cudnn.allow_tf32 = ambient
            outs[ambient] = StreamingRunner(model, configs[name], device=dev).forward(
                sample).cpu().numpy()
            after[ambient] = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        same = outs[True].tobytes() == outs[False].tobytes()
        same4 = outs[False].tobytes() == phase4.tobytes()
        log(f"at {name}: the output with the caller's cuDNN TF32 flag on bit-equal to off "
            f"{same}, to phase 4's {same4}; the flag after the call {after} (set True, "
            "False)")
        if not (same and same4 and after == {True: True, False: False}):
            failures.append(f"{name}: not decided by the config ({same}, {same4}, {after})")

    # (d) Training at "high" on one batch of the recipe: kernel path against plain path,
    # every conv's flags; then the step against "highest" in turns.
    train_cfg = load_params_yaml(None)
    train_cfg.update({"num_workers": 4, "debug_image_freq": 0, "plot_freq": 0})
    long_dir, long_split = inputs["long"]
    train_set = train_cli.make_dataset(train_cfg, long_dir, long_split, True, 0,
                                       np.random.default_rng(0))
    batch = collate([train_set[i] for i in range(TRAIN_B)])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if not k.endswith("filenames")}
    state0 = random_state_dict(0)

    def fresh(impl, precision):
        net = MultiViewStereoNet()
        net.load_state_dict(state0)
        net = net.to(dev)
        config, loss_config, _, step = train_cli.build_train_step(
            dict(train_cfg, matmul_precision=precision), 12, net, impl)
        return net, config, loss_config, step

    grads, loss_of, spies = {}, {}, {}
    torch.backends.cudnn.allow_tf32 = True  # the caller's flag: the step must not use it
    for impl in ("auto", "plain"):
        net, config, loss_config, _ = fresh(impl, "high")
        zero_launches()
        zero_tf32_launches()
        with ConvSpy() as spy:
            loss, _ = make_loss_fn(config, loss_config, impl=impl)(net, batch)
            loss.backward()
            torch.cuda.synchronize()
        spies[impl] = spy.summary()
        loss_of[impl] = loss.item()
        grads[impl] = {k: p.grad for k, p in net.named_parameters()}
        if impl == "auto":
            step_launches, step_tf32 = read_launches(), tf32_launches()
    torch.backends.cudnn.allow_tf32 = False
    flat = {impl: torch.cat([grads[impl][k].flatten() for k in sorted(grads[impl])])
            for impl in grads}
    flat_gap = ((flat["auto"] - flat["plain"]).norm() / flat["plain"].norm()).item()
    loss_gap = abs(loss_of["auto"] - loss_of["plain"]) / abs(loss_of["plain"])
    worst, worst_key, min_cos = compare_gradients(grads)
    want = {("forward", "model"): {(True, False)}, ("backward", "model"): {(True, False)},
            ("forward", "loss"): {(False, False)}, ("backward", "loss"): {(False, False)}}
    log(f"train step at high, kernel vs plain path (B={TRAIN_B}, the caller's cuDNN flag "
        f"on): launches {step_launches} a step, 1xTF32 {step_tf32}; loss "
        f"{loss_of['auto']:.6f} vs {loss_of['plain']:.6f} ({loss_gap:.2e} relative, bar "
        f"{TF32_TRAIN_LOSS_BAR:.0e}); flat gradient {flat_gap:.3e} relative L2 (bar "
        f"{TF32_TRAIN_GRAD_BAR:.0e}); worst leaf {worst:.3e} at {worst_key}, least cosine "
        f"{min_cos:.6f}; conv flags (cuDNN TF32, cuBLAS TF32) seen: "
        f"{ {impl: {' '.join(k): sorted(v) for k, v in s.items()} for impl, s in spies.items()} }")
    if not (np.isfinite(loss_of["auto"]) and loss_gap <= TF32_TRAIN_LOSS_BAR
            and flat_gap <= TF32_TRAIN_GRAD_BAR):
        failures.append(f"train at high, kernel against plain: loss {loss_gap}, flat {flat_gap}")
    # Every conv seen at its stage's flags; the model's forward and backward both seen
    # (the recipe's supervised losses may blur nothing that needs a gradient).
    if step_tf32 != {"chain": 1, "refiner": 2} or any(
            not {("forward", "model"), ("backward", "model")} <= set(s)
            or any(v != want[k] for k, v in s.items()) for s in spies.values()):
        failures.append(f"train at high: 1xTF32 launches {step_tf32}, conv flags {spies}")
    del grads, flat

    steps_by = {p: fresh("auto", p) for p in ("highest", "high")}
    times, peak = time_steps(steps_by, batch, per_round=3)
    ms = {k: statistics.median(t) for k, t in times.items()}
    busy, fft = {}, {}
    for p, (net, _, _, step) in steps_by.items():
        busy[p], _, prof = profile_kernels(lambda: step(net, batch), 1)
        fft[p] = fft_share(prof)
    for p in steps_by:
        log(f"train step at {p}, B={TRAIN_B} V=1 {H0}x{W0} D={D}, adam, kernel path: "
            f"{ms[p]:.3f} ms a step (median of {len(times[p])}, in turns; "
            f"{[round(t, 2) for t in times[p]]}), {TRAIN_B * 1e3 / ms[p]:.2f} images/s, "
            f"device busy {busy[p]:.3f} ms, peak memory {peak[p] / 2**30:.3f} GiB; cuDNN FFT "
            f"kernels {fft[p][1]} taking {fft[p][0]:.3f} ms of device ({smi})")
    del steps_by

    # train() with matmul_precision: high in its params: 2 steps, a checkpoint.
    out = os.path.join(inputs["root"], "train_high")
    zero_launches()
    zero_tf32_launches()
    trained = train_cli.train(dict(train_cfg, num_epochs=1, matmul_precision="high"),
                              long_dir, long_split, "", out, max_steps=TF32_TRAIN_STEPS,
                              device=dev)
    cli_launches, cli_tf32 = read_launches(), tf32_launches()
    with open(os.path.join(out, "losses.txt")) as f:
        rows = [line.split() for line in f.read().splitlines()[1:]]
    losses = [float(r[3]) for r in rows]
    ckpt = native.load_train_state(os.path.join(out, "checkpoints"), 0)
    f32_weights = (all(p.dtype == torch.float32 for p in trained.parameters())
                   and all(v.dtype == torch.float32 for v in ckpt["model"].values()))
    expected = expected_launches([(TRAIN_B, 1)] * TF32_TRAIN_STEPS)
    log(f"train() with matmul_precision high: {len(rows)} steps, losses {losses}, launches "
        f"{cli_launches} (expected {expected}), 1xTF32 {cli_tf32}; checkpoint step "
        f"{ckpt['step']}, weights and checkpoint f32 {f32_weights}")
    if not (len(rows) == TF32_TRAIN_STEPS and np.isfinite(losses).all() and f32_weights
            and ckpt["step"] == TF32_TRAIN_STEPS and cli_launches == expected
            and cli_tf32 == {"chain": TF32_TRAIN_STEPS, "refiner": 2 * TF32_TRAIN_STEPS}):
        failures.append("train() at high: steps, losses, launches or checkpoint")
    del trained, ckpt

    # (e) The artifact at "high" served in a fresh process with the flag off, and at
    # "highest" in one with the flag on: each bit-equal to the live forward at its
    # precision. Then ("refiners", "high") at "highest", in a fresh process with the flag
    # off and in one with it on: bit-equal to the live forward at that config, the
    # refiners' convs the conv op under cuDNN's TF32 flag and every other conv without it
    # (a spy on every conv: ``conv_flags``), K3 at 1xTF32 and K2 not.
    override = dataclasses.replace(configs["highest"], stage_precision=(("refiners", "high"),))
    cases = (("high", configs["high"], (False,), {"chain": 1, "refiner": 2}),
             ("highest", configs["highest"], (True,), {"chain": 0, "refiner": 0}),
             ("refiners_high", override, (False, True), {"chain": 0, "refiner": 2}))
    codes = {}
    for name, config, ambients, _ in cases:
        path = os.path.join(inputs["root"], f"serving_b1_{name}.pt2")
        export.save_exported(export.export_inference(model, config, size=(H0, W0)), path)
        live = StreamingRunner(model, config, device=dev).forward(sample).cpu().numpy()
        io_path = os.path.join(inputs["root"], f"artifact_io_{name}.npz")
        np.savez(io_path, live=live, **sample)
        for ambient in ambients:
            codes[name, ambient] = (
                f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
                f"chip_smoke.artifact_child({path!r}, {io_path!r}, {str(dev)!r}, {ambient}, "
                f"spy={config is override})")
    artifacts = fresh_processes(codes, "the artifact at")
    for name, config, ambients, want_tf32 in cases:
        spy = config is override
        for ambient in ambients:
            child = artifacts[name, ambient]
            log(f"artifact at {name} B=1 in a fresh process with the cuDNN TF32 flag "
                f"{'on' if ambient else 'off'}: mode {child['mode']}, bit-equal to the live "
                f"forward at {name} {child['equal']}, launches {child['launches']}, 1xTF32 "
                f"{child['tf32_launches']}, the flag after the call {child['flags_after']}"
                + (f"; custom ops {child['ops']}; cuDNN's TF32 flag at each conv, by kind "
                   f"and module, {child['conv_flags']}" if spy else ""))
            # The refiners' convs all ops with the flag on, every other an aten conv with
            # it off.
            flags = child["conv_flags"] or {}
            staged = {k: [k.startswith("op refiner")] for k in flags
                      if k.startswith("op refiner") or (k.startswith("aten ")
                                                        and " refiner" not in k)}
            held = not spy or ("mvs_torch::convolution" in child["ops"]
                               and any(k.startswith("op ") for k in flags)
                               and flags == staged)
            if not (child["equal"] and child["tf32_launches"] == want_tf32
                    and child["flags_after"] == [ambient, False] and held):
                failures.append(f"the {name} artifact: {child}")
    if failures:
        raise AssertionError("phase 13: " + "; ".join(failures))
    return {"kernels": kernels, "launches": launches_tf32, "deviation": deviation,
            "stages": stages, "timing": timing, "train_ms": ms, "train_busy": busy,
            "train_peak_gib": {k: v / 2**30 for k, v in peak.items()}, "fft": fft,
            "train_launches": step_tf32, "loss_gap": loss_gap, "grad_gap": flat_gap}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def fresh_processes(codes: dict, what: str) -> dict:
    """Run each ``python -c`` code of ``codes`` in a fresh process, all at once (a fresh
    process spends ~8-25 s starting up and loading before it runs anything); the last line
    of each one's output as JSON, by key. Raises, with its errors, for one that fails."""
    procs = {k: subprocess.Popen([sys.executable, "-c", code], cwd=REPO, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for k, code in codes.items()}
    outs = {}
    try:
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{what} {k} in a fresh process failed:\n{err[-3000:]}")
            outs[k] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def spawn(spec: dict, n: int) -> list:
    """Start ``n`` processes of ``child`` on ``spec``, ranks 0..n-1 of one group whose
    store is on a free local port (each round's its own); collect them
    (``tests/_torch_distributed_worker.py`` ``wait``: all killed at the limit) and raise
    unless every one exits 0. Returns each one's last stdout line as JSON, and its
    stdout."""
    port = free_port()
    if "rounds" in spec:
        ports = {port}
        while len(ports) <= len(spec["rounds"]):
            ports.add(free_port())
        spec = dict(spec, rounds=[dict(run, port=p) for run, p in
                                  zip(spec["rounds"], sorted(ports - {port}))])
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
         f"chip_smoke.child({json.dumps(dict(spec, rank=r, n=n, port=port))!r})"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    results = tests_module("_torch_distributed_worker").wait(procs, timeout=600)
    for r, (rc, out, err) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"{spec['kind']} process {r} of {n} exited {rc}:\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
    return [(json.loads(out.strip().splitlines()[-1]), out) for _, out, _ in results]


def child(spec_json: str):
    """Phase 10's and 12's processes. "train": ``train_cli.main`` as rank ``rank`` of
    ``n`` on the card, the host clock stamped at each step's stop check (with
    ``record``, what each step trained on saved there:
    ``tests/_torch_distributed_worker.py`` ``record_training``); prints its launches,
    stamps and peak memory; with ``rounds`` (each an ``argv``, a ``port`` and optionally
    a ``record``), one such run a round in this process, in turn, and a list of their
    results. "nccl": joins a group of one over NCCL, one train step
    through the mesh (its gradients all-reduced over NCCL) and one without, on the same
    batch and weights, then leaves; prints the backend, both losses and the worst
    gradient gap."""
    spec = json.loads(spec_json)
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if spec["kind"] == "train":
        from multi_view_stereonet_tpu_torch.train import train_cli

        worker = tests_module("_torch_distributed_worker")
        stamps = []

        class StampedStop(train_cli.GracefulStop):
            def __call__(self):
                stamps.append(time.perf_counter())
                return super().__call__()

        train_cli.GracefulStop = StampedStop
        results = []
        for run in spec.get("rounds", [spec]):
            stamps.clear()
            zero_launches()
            torch.cuda.reset_peak_memory_stats()
            with (worker.record_training(train_cli, run["record"], spec["rank"])
                  if run.get("record") else contextlib.nullcontext()):
                train_cli.main(run["argv"] + ["--coordinator", f"localhost:{run['port']}",
                                              "--num_processes", str(spec["n"]),
                                              "--process_id", str(spec["rank"])])
            results.append({"launches": read_launches(), "stamps": list(stamps),
                            "peak": torch.cuda.max_memory_allocated(),
                            "device": torch.cuda.current_device()})
        print(json.dumps(results if "rounds" in spec else results[0]), flush=True)
        return
    import torch.distributed as dist

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.parallel import join, make_process_mesh, shutdown
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    t0 = time.perf_counter()
    dev = join(f"localhost:{spec['port']}", 1, 0)
    backend = dist.get_backend()
    mesh = make_process_mesh()
    init_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in np.load(spec["batch"]).items()}
    cfg = dict(load_params_yaml(None), optimizer="sgd", learning_rate=0.0)
    losses, grads = [], {}
    for name, m in (("auto", mesh), ("plain", None)):  # compare_gradients' names
        model = MultiViewStereoNet()
        model.load_state_dict(random_state_dict(0))
        model = model.to(dev)
        _, _, _, step = train_cli.build_train_step(cfg, 1, model, mesh=m)
        loss, _ = step(model, batch)
        losses.append(loss.item())
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    shutdown()
    print(json.dumps({"backend": backend, "device": str(dev), "init_s": init_s,
                      "loss": losses, "grad_err": compare_gradients(grads)[0],
                      "initialized_after": dist.is_initialized()}), flush=True)


def view_group_phase(dev, root, smi, loss_fn, failures) -> dict:
    """Phase 10 (e), one loader a view group: two processes at mesh_view 2 on a V = 2
    tree at the recipe (B = 8, augmentation on), in one spawn: a run at 4 loader
    threads recording what each step trained on, held to one process's ``loss_fn`` on
    the batch the leader loaded; then the CLI loop timed at 1 and 4 threads in turns. A
    check missed is appended to ``failures``. Returns the times, checks and peaks."""
    import yaml

    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.parallel import ProcessMesh
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    worker = tests_module("_torch_distributed_worker")
    view_dir, view_split = synthetic_data().make_gta_sfm_tree(
        os.path.join(root, "long_v2"), num_sequences=1, frames=VIEW_STEPS * TRAIN_B + 2,
        rows=H0, cols=W0, seed=5, comparisons=2)
    view_cfg = load_params_yaml(None)
    view_cfg.update({"mesh_view": 2, "debug_image_freq": 0, "plot_freq": 0,
                     "num_epochs": 1, "print_freq": 1})
    record = os.path.join(root, "view_record")

    def view_run(name, workers, steps):
        path = os.path.join(root, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(dict(view_cfg, num_workers=workers), f)
        return {"argv": ["--config", path, "--data_dir", view_dir, "--train_split",
                         view_split, "--output_dir", os.path.join(root, name),
                         "--max_steps", str(steps)]}
    rounds = [dict(view_run("view_record", 4, VIEW_RECORD_STEPS), record=record)] + [
        view_run(f"view_turn{i}", w, VIEW_STEPS) for i, w in enumerate(VIEW_TURNS)]
    t0 = time.perf_counter()
    view = spawn({"kind": "train", "rounds": rounds}, MP_PROCESSES)
    view_s = time.perf_counter() - t0
    ranks = []
    for r in range(MP_PROCESSES):
        with open(os.path.join(record, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    loaded_by_others = [f for f in os.listdir(record)
                        if f.startswith("loaded") and not f.endswith("_rank0.npz")]
    log(f"mesh_view 2, two processes at the recipe on a V=2 tree (B={TRAIN_B}, "
        f"augmentation on, 4 loader threads), one loader a view group: {VIEW_RECORD_STEPS} "
        f"recorded steps and {len(VIEW_TURNS)} timed runs in {view_s:.1f} s; samples "
        f"decoded by process {[r['decoded'] for r in ranks]}; batches saved by another "
        f"process than the leader {loaded_by_others}")
    if ranks[1]["decoded"] or loaded_by_others or ranks[0]["decoded"] < (
            VIEW_RECORD_STEPS * TRAIN_B):
        failures.append(f"one loader a view group: decoded {[r['decoded'] for r in ranks]}")
    view_mesh = [ProcessMesh(view=2, view_index=r) for r in range(MP_PROCESSES)]
    model = MultiViewStereoNet().to(dev)
    view_checks = []
    for k in range(VIEW_RECORD_STEPS):
        loaded = dict(np.load(os.path.join(record, f"loaded{k}_rank0.npz")))
        same = [rank["digests"][k] == {key: worker.digest(v) for key, v in
                                       view_mesh[r].shard_batch(loaded).items()}
                for r, rank in enumerate(ranks)]
        rec = torch.load(os.path.join(record, f"step{k}.pt"), weights_only=True)
        model.load_state_dict(rec["weights"])
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, {key: torch.from_numpy(v).to(dev)
                                  for key, v in loaded.items()})
        loss.backward()
        worst, worst_key, min_cos = compare_gradients({
            "plain": {n: p.grad for n, p in model.named_parameters()},
            "auto": {n: g.to(dev) for n, g in rec["grads"].items()}})
        loss_gap = abs(rec["loss"] - loss.item()) / abs(loss.item())
        view_checks.append({"digests_equal": same, "loss_gap": loss_gap, "grad_err": worst})
        B, V = loaded["right_images"].shape[:2]
        log(f"mesh_view 2, step {k + 1}: each process trained on its share of the leader's "
            f"B={B} V={V} batch (SHA-256 of every tensor) {same}; from the weights they "
            f"entered it with, one process's loss on that batch {loss.item():.6f} against "
            f"theirs {rec['loss']:.6f} ({loss_gap:.2e}, bar {LOSS_BAR:.0e}); their gradient "
            f"against one process's, worst {worst:.3e} of max|one process| at {worst_key} "
            f"(bar {GRAD_BAR:.1e}), least cosine {min_cos:.9f} (bar {COS_BAR})")
        if not (all(same) and loss_gap <= LOSS_BAR and worst <= GRAD_BAR
                and min_cos > COS_BAR):
            failures.append(f"mesh_view 2 step {k + 1}: {view_checks[-1]}")
    del model
    per_view_step = expected_launches([(TRAIN_B, 1)])
    view_ms = {w: [] for w in sorted(set(VIEW_TURNS))}
    for w, runs in zip(VIEW_TURNS, zip(*(result[1:] for result, _ in view))):
        view_ms[w].append([float(np.median(np.diff(run["stamps"][:-1])[2:] * 1e3))
                           for run in runs])
        if any(run["launches"] != {k: VIEW_STEPS * v for k, v in per_view_step.items()}
               for run in runs):
            failures.append(f"mesh_view 2 launches {[run['launches'] for run in runs]} in "
                            f"{VIEW_STEPS} steps, expected {per_view_step} a step")
    view_peak = [result[2]["peak"] / 2**30 for result, _ in view]
    log(f"mesh_view 2 at the recipe (B={TRAIN_B} V=2, a view a process, augmentation on), "
        f"the CLI loop ms a step by process (median of steps 4-{VIEW_STEPS - 1}, host "
        f"clock), in turns {list(VIEW_TURNS)} loader threads: "
        + "; ".join(f"{w} threads {[[round(m, 3) for m in run] for run in runs]}"
                    for w, runs in view_ms.items())
        + f"; peak memory {[round(p, 3) for p in view_peak]} GiB a process at 4 threads; "
        f"launches a process-step {per_view_step} ({smi})")
    return {"ms": view_ms, "checks": view_checks, "peak_gib": view_peak}


def multi_process_phase(dev, inputs, smi, cli_ms):
    """Phase 10: training as two processes on the card over gloo (the train CLI at the
    recipe's width, held to one process's steps on the concatenated per-process
    batches, resumed; then timed at the recipe), the data- and view-sharded steps'
    gradients, and the NCCL route at a world size of one. Every part runs; any that
    fails its check fails the phase at the end. Returns a summary."""
    import yaml

    from multi_view_stereonet_tpu_torch.checkpoint import (
        init_params_numpy, native, random_state_dict, state_dict_from_jax_params)
    from multi_view_stereonet_tpu_torch.data.loader import collate
    from multi_view_stereonet_tpu_torch.losses import LossConfig
    from multi_view_stereonet_tpu_torch.models import (
        MultiViewStereoNet, MultiViewStereoNetConfig)
    from multi_view_stereonet_tpu_torch.parallel import ShardedDataset
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    root = inputs["root"]
    data_dir, split = inputs["long"]
    local = TRAIN_B // MP_PROCESSES
    worker = tests_module("_torch_distributed_worker")
    failures = []

    def argv(cfg, name, out):
        path = os.path.join(root, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return ["--config", path, "--data_dir", data_dir, "--train_split", split,
                "--output_dir", out]

    # (a) The recipe's width for the comparison: no augmentation, one loader thread.
    cfg = load_params_yaml(None)
    cfg.update({"num_workers": 1, "augment": False, "debug_image_freq": 0, "plot_freq": 0,
                "print_freq": 1, "num_epochs": 1})
    out = os.path.join(root, "train_mp")
    args = argv(cfg, "train_mp", out)
    records = [os.path.join(root, f"train_mp_steps{i}") for i in (0, 1)]
    t0 = time.perf_counter()
    spawn({"kind": "train", "argv": args + ["--max_steps", str(MP_STEPS)],
           "record": records[0]}, MP_PROCESSES)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = spawn({"kind": "train", "argv": args + [
        "--max_steps", str(MP_STEPS + MP_RESUME), "--max_epochs", "2"],
        "record": records[1]}, MP_PROCESSES)
    resume_s = time.perf_counter() - t0
    ckpt_root = os.path.join(out, "checkpoints")
    with open(os.path.join(out, "losses.txt")) as f:
        rows = [line.split() for line in f.read().splitlines()[1:]]
    state = native.load_train_state(ckpt_root, 1)
    if (sorted(os.listdir(ckpt_root)) != ["epoch0000", "epoch0001"]
            or f"resumed from epoch 0 (step {MP_STEPS})" not in resumed[0][1]
            or [int(r[2]) for r in rows] != list(range(1, MP_STEPS + MP_RESUME + 1))
            or state["step"] != MP_STEPS + MP_RESUME
            or any(k.startswith("module.") for k in state["model"])):
        raise AssertionError(f"two-process train: checkpoints {os.listdir(ckpt_root)}, "
                             f"losses.txt steps {[r[2] for r in rows]}, state step "
                             f"{state['step']}")

    # One process's train_step on the per-process batches concatenated in rank order,
    # on the kernel path and on the plain path. Step 1 starts from the init, step 4 from
    # the CLI's epoch-0 checkpoint (weights and adam's state), step 5 one update after
    # it: held to LOSS_BAR. Steps 2 and 3 follow adam's first updates from a zero second
    # moment, which move every weight by about the rate whatever the size of its
    # gradient, so a gradient element near zero whose last bits differ moves the other
    # way: their drift is printed beside that between one process's kernel and plain
    # paths and held only to DRIFT_BAR, which a wrong batch would exceed. The step-1
    # gradients themselves are held to phase 7's bar in (b).
    init = state_dict_from_jax_params(init_params_numpy(cfg["seed"], reference=True))

    def concatenated(epoch, steps):
        loaders = []
        for r in range(MP_PROCESSES):
            dataset = train_cli.make_dataset(cfg, data_dir, split, True, 0,
                                             np.random.default_rng(cfg["seed"]))
            loader = train_cli.BatchLoader(ShardedDataset(dataset, r, MP_PROCESSES), local,
                                           shuffle=cfg["shuffle"], seed=cfg["seed"],
                                           workers=1)
            loader.set_epoch(epoch)
            loaders.append(loader)
        return [{k: np.concatenate([p[k] for p in parts]) for k in parts[0]
                 if not k.endswith("filenames")}
                for _, parts in zip(range(steps), zip(*loaders))]

    batches = concatenated(0, MP_STEPS) + concatenated(1, MP_RESUME)
    ref = {}
    for impl in ("auto", "plain"):
        model = MultiViewStereoNet()
        model.load_state_dict(init)
        model = model.to(dev).train()
        _, _, optimizer, step = train_cli.build_train_step(cfg, 1, model, impl)
        ref[impl] = []
        for k, batch in enumerate(batches):
            if k == MP_STEPS:  # the relaunch resumes from the CLI's checkpoint
                saved = native.load_train_state(ckpt_root, 0)
                model.load_state_dict(saved["model"])
                optimizer.load_state_dict(saved["optimizer"])
            lossf, host_dict = train_cli._losses_to_host(*step(model, {
                key: torch.from_numpy(v).to(dev) for key, v in batch.items()}))
            ref[impl].append([lossf] + [x for v in host_dict.values()
                                        for x in (v if isinstance(v, list) else [v])])
    got = np.array([row[3:] for row in rows], float)
    want, plain = np.array(ref["auto"]), np.array(ref["plain"])
    gaps = np.max(np.abs(got - want) / np.abs(want), axis=1).tolist()
    plain_gaps = (np.abs(want[:, 0] - plain[:, 0]) / np.abs(plain[:, 0])).tolist()
    held = (0, MP_STEPS, MP_STEPS + 1)
    log(f"two processes (gloo, one card), the train CLI at B={TRAIN_B} ({local} a process) "
        f"{H0}x{W0} D={D}, adam, no augmentation: {MP_STEPS} steps in {first_s:.1f} s, "
        f"resumed for {MP_RESUME} in {resume_s:.1f} s (start-up included); one checkpoint "
        f"an epoch {sorted(os.listdir(ckpt_root))}; process 0's losses.txt against one "
        f"process's train_step on the concatenated batches, worst relative gap by step "
        f"{[f'{g:.2e}' for g in gaps]} (steps {[k + 1 for k in held]} held to "
        f"{LOSS_BAR:.0e}, the others to {DRIFT_BAR:.0e}); one process's kernel against "
        f"plain path, loss by step {[f'{g:.2e}' for g in plain_gaps]}; losses "
        f"{[round(float(r[3]), 4) for r in rows]}")
    if any(g > (LOSS_BAR if k in held else DRIFT_BAR) for k, g in enumerate(gaps)):
        failures.append(f"two-process losses.txt against one process: {gaps}")

    # At every step, from the weights the two processes held as they entered it (process
    # 0's record), one process's loss and gradient on the same global batch, against the
    # gradient the two processes applied: phase 7's bar, with no adam drift in between.
    recorded = [torch.load(os.path.join(records[k >= MP_STEPS],
                                        f"step{k - MP_STEPS * (k >= MP_STEPS)}.pt"),
                           weights_only=True) for k in range(len(batches))]
    model = MultiViewStereoNet().to(dev)
    loss_fn = make_loss_fn(MultiViewStereoNetConfig(num_idepth_samples=D), LossConfig())
    step_grads = []
    for k, (batch, rec) in enumerate(zip(batches, recorded)):
        model.load_state_dict(rec["weights"])
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, {key: torch.from_numpy(v).to(dev) for key, v in batch.items()})
        loss.backward()
        worst, worst_key, min_cos = compare_gradients({
            "plain": {n: p.grad for n, p in model.named_parameters()},
            "auto": {n: g.to(dev) for n, g in rec["grads"].items()}})
        loss_gap = abs(float(rows[k][3]) - loss.item()) / abs(loss.item())
        step_grads.append(worst)
        log(f"two processes, step {k + 1}: from the weights they entered it with, one "
            f"process's loss {loss.item():.6f} against losses.txt {float(rows[k][3]):.6f} "
            f"({loss_gap:.2e}); the two processes' gradient against one process's, worst "
            f"{worst:.3e} of max|one process| at {worst_key} (bar {GRAD_BAR:.1e}), least "
            f"cosine {min_cos:.9f} (bar {COS_BAR})")
        if not (worst <= GRAD_BAR and min_cos > COS_BAR and loss_gap <= LOSS_BAR):
            failures.append(f"two-process gradient at step {k + 1}: worst {worst}, cosine "
                            f"{min_cos}, loss gap {loss_gap}")
    del model, recorded

    # (d) At the recipe, as phase 7 runs it (augmentation on, 4 loader threads a
    # process), timed by each process's host clock at its stop check.
    recipe = load_params_yaml(None)
    recipe.update({"num_workers": 4, "debug_image_freq": 0, "plot_freq": 0,
                   "num_epochs": 1})
    timed = spawn({"kind": "train", "argv": argv(recipe, "train_mp_recipe", os.path.join(
        root, "train_mp_recipe")) + ["--max_steps", str(MP_TIMED_STEPS)]}, MP_PROCESSES)
    per_step = expected_launches([(local, 1)])
    if any(t[0]["launches"] != {k: MP_TIMED_STEPS * v for k, v in per_step.items()}
           for t in timed):
        failures.append(f"two-process launches {[t[0]['launches'] for t in timed]} in "
                        f"{MP_TIMED_STEPS} steps, expected {per_step} a step")
    ms = [float(np.median(np.diff(t[0]["stamps"][:-1])[2:] * 1e3)) for t in timed]
    peak = [t[0]["peak"] / 2**30 for t in timed]
    log(f"two processes at the recipe (B={TRAIN_B}, {local} a process, augmentation on, 4 "
        f"loader threads a process): the CLI loop {ms[0]:.3f} / {ms[1]:.3f} ms a step "
        f"(process 0 / 1, median of steps 4-{MP_TIMED_STEPS - 1}, host clock; "
        f"{[round(float(g) * 1e3, 1) for g in np.diff(timed[0][0]['stamps'][:-1])]}), "
        f"{TRAIN_B * 1e3 / max(ms):.2f} images/s; one process (phase 7) {cli_ms:.3f} ms a "
        f"step; peak memory {peak[0]:.3f} / {peak[1]:.3f} GiB a process; launches a "
        f"process-step {per_step} ({smi})")

    # (b) Against one process on the card: a data-sharded step on (a)'s first global
    # batch from the CLI's init, and mesh_view 2 (a view a process) on the V = 2 tree.
    tree, tree_split = inputs["trees"][2]
    dataset = train_cli.make_dataset(cfg, tree, tree_split, True, 0, np.random.default_rng(0))
    cases = {"data": (batches[0], init, 1),
             "view": ({k: v for k, v in collate([dataset[i] for i in range(len(dataset))]
                                                 ).items() if not k.endswith("filenames")},
                      random_state_dict(0), 2)}
    job = {"mode": "step", "device": "cuda", "out": root, "cases": {}}
    for name, (batch, weights, view) in cases.items():
        np.savez(os.path.join(root, f"mp_{name}.npz"), **batch)
        torch.save(weights, os.path.join(root, f"mp_{name}.pth"))
        job["cases"][name] = {"weights": os.path.join(root, f"mp_{name}.pth"),
                              "batch": os.path.join(root, f"mp_{name}.npz"),
                              "two_view": False, "D": D, "factors": {}, "mesh_view": view}
    results = worker.wait(worker.start(job, root, "mp_steps"), timeout=600)
    for r, (rc, _, err) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"step process {r} exited {rc}:\n{err[-4000:]}")
    sharded = {}
    for name, (batch, weights, view) in cases.items():
        model = MultiViewStereoNet()
        model.load_state_dict(weights)
        model = model.to(dev)
        loss, _ = make_loss_fn(MultiViewStereoNetConfig(num_idepth_samples=D), LossConfig())(
            model, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        loss.backward()
        grads = {"plain": {k: p.grad for k, p in model.named_parameters()}}
        r0, r1 = (np.load(os.path.join(root, f"{name}_rank{r}.npz")) for r in (0, 1))
        grads["auto"] = {k: torch.from_numpy(r0[f"grad/{k}"]).to(dev) for k in grads["plain"]}
        worst, worst_key, min_cos = compare_gradients(grads)
        gap = abs(float(r0["loss"]) - loss.item()) / abs(loss.item())
        sharded[name] = {"loss_gap": gap, "grad_err": worst}
        B, V = batch["right_images"].shape[:2]
        log(f"two processes, {'a view each' if view > 1 else f'{B // 2} samples each'}"
            f" (mesh_view {view}), B={B} V={V} {H0}x{W0} D={D}, against one process: loss "
            f"{float(r0['loss']):.6f}, equal on both {bool(r0['loss'] == r1['loss'])}, "
            f"{gap:.2e} relative (bar {LOSS_BAR:.0e}); worst gradient {worst:.3e} of "
            f"max|one process| at {worst_key} (bar {GRAD_BAR:.1e}), least cosine "
            f"{min_cos:.9f} (bar {COS_BAR})")
        if not (r0["loss"] == r1["loss"] and gap <= LOSS_BAR and worst <= GRAD_BAR
                and min_cos > COS_BAR):
            failures.append(f"the {name}-sharded step against one process: {sharded[name]}")

    # (e) One loader a view group.
    view = view_group_phase(dev, root, smi, loss_fn, failures)

    # (c) The NCCL route at a world size of one.
    (nccl, _), = spawn({"kind": "nccl", "batch": os.path.join(root, "mp_view.npz")}, 1)
    log(f"NCCL at one process: backend {nccl['backend']} on {nccl['device']}, joined and "
        f"meshed in {nccl['init_s']:.2f} s; a step through the mesh (its gradients "
        f"all-reduced over NCCL) loss {nccl['loss'][0]:.6f} against {nccl['loss'][1]:.6f} "
        f"without, worst gradient gap {nccl['grad_err']:.3e} of max|without| (bar "
        f"{GRAD_BAR:.1e}); left the group {not nccl['initialized_after']}")
    if not (nccl["backend"] == "nccl" and not nccl["initialized_after"]
            and abs(nccl["loss"][0] - nccl["loss"][1]) <= LOSS_BAR * abs(nccl["loss"][1])
            and nccl["grad_err"] <= GRAD_BAR):
        failures.append(f"the NCCL route: {nccl}")
    log(f"not run on this machine ({torch.cuda.device_count()} card): NCCL across several "
        "cards, and a kernel launched on its tensors' card while another is current "
        "(tests/test_torch_cuda.py::test_kernels_launch_on_their_tensors_card_when_another"
        "_is_current skips below two cards)")
    if failures:
        raise AssertionError("phase 10: " + "; ".join(failures))
    return {"per_step": per_step, "ms": ms, "peak_gib": peak, "loss_gaps": gaps,
            "step_grad_errs": step_grads, "sharded": sharded,
            "view_feed": view}


class Deadline:
    """``with Deadline(what):`` ends the process with exit code 1, after printing what
    did not finish, if its body runs past ``seconds``: a wait on the card that never
    returns (two cooperative grids each waiting at a grid barrier for the other's SMs)
    fails the run instead of hanging it. ``os._exit``: a normal exit frees the card's
    memory, which waits for the hung card."""

    def __init__(self, what, seconds=REPLICA_DEADLINE):
        self.what, self.seconds = what, seconds

    def __enter__(self):
        self.timer = threading.Timer(self.seconds, self.expire)
        self.timer.daemon = True
        self.timer.start()
        return self

    def __exit__(self, *exc):
        self.timer.cancel()
        return False

    def expire(self):
        log(f"phase 14: {self.what} did not finish within {self.seconds:.0f} s; the card "
            "hangs")
        os._exit(1)


class Cycled:
    """``n`` requests: ``dataset``'s, taken again from its first once they run out."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def cooperative_grids(dev, smi, failures):
    """Phase 14 (a): K3, a cooperative launch of up to one block a SM, queued on two
    streams at once, as two replicas on one card queue it. Per shape, two CUDA graphs of
    2 x REPLICA_PROBE_CALLS launches, all on one stream or split over two parallel
    branches (each stream with its own barrier counter, made by an eager launch first),
    replayed in turns (one, two, two, one) with every wait under a deadline: ms a launch
    of each, device time alone (a launch dispatched from the host takes longer than
    one's device time, so a host-timed run would compare host costs); two / one near 1
    says the grids run one at a time, near 0.5 that they share the card. Each branch's
    last output bit-equal to a launch alone."""
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.models import IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

    state = random_state_dict(4)
    with torch.inference_mode(False):
        module = IDepthmapRefiner(35)
        module.load_state_dict({k[len("refiner4."):]: v for k, v in state.items()
                                if k.startswith("refiner4.")})
        module = module.to(dev).eval()
    g = torch.Generator().manual_seed(14)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    calls = 2 * REPLICA_PROBE_CALLS
    ratios = {}
    for n in (1, 8):
        guidance = (torch.rand(n, 35, 30, 40, generator=g) * 2 - 1).to(dev)
        idepth = (torch.rand(n, 30, 40, generator=g) * 20).to(dev)

        def launch():
            return refiner_op.idepthmap_refiner(module, guidance, idepth, impl="kernel")
        with torch.inference_mode():
            ref = launch()
            for s in streams:
                s.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(s):
                    launch()
            with Deadline(f"K3 at n={n} on each stream"):
                torch.cuda.synchronize(dev)
            graphs = {}
            for k in (1, 2):
                graph, last = torch.cuda.CUDAGraph(), {}
                with torch.cuda.graph(graph, stream=streams[0]):
                    if k == 2:
                        streams[1].wait_stream(streams[0])
                    for c in range(calls):
                        with torch.cuda.stream(streams[c % k]):
                            last[c % k] = launch()
                    if k == 2:
                        streams[0].wait_stream(streams[1])
                graphs[k] = graph, last
            times = {1: [], 2: []}
            for k in (1, 2, 2, 1):
                graph, last = graphs[k]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                with Deadline(f"{calls} K3 launches at n={n} on {k} stream(s)"):
                    end.synchronize()
                times[k].append(start.elapsed_time(end) / calls)
                if not all(torch.equal(o, ref) for o in last.values()):
                    failures.append(f"K3 at n={n} on {k} stream(s) differs from a launch "
                                    "alone")
            del graphs
        one, two = statistics.median(times[1]), statistics.median(times[2])
        ratios[n] = two / one
        log(f"replicas (a): K3 (n={n},35,30,40), {calls} launches in a CUDA graph: one "
            f"stream {', '.join(f'{t:.4f}' for t in times[1])} ms a launch, two parallel "
            f"branches {', '.join(f'{t:.4f}' for t in times[2])}; two / one "
            f"{ratios[n]:.3f} (near 1: the grids run one at a time; near 0.5: they share "
            f"the card); outputs bit-equal to a launch alone ({smi})")
    return ratios


def replica_phase(dev, inputs, smi):
    """Phase 14: the runner over two replicas on the one card (the card named twice).
    (a) ``cooperative_grids``. (b) The V = 1 tree's four requests and its first again,
    at batch 2 (two split steps, then the tail whole on replica 0), against one replica
    at batch 1, whose forwards see the same batches: bit-equal over f32 and u8, the f16
    fetch the f32 output cast; the launches of five B = 1 forwards; one K3 barrier
    counter a replica stream; the caller's cuDNN TF32 flag unchanged, off and on. (c) The
    LONG tree at B = 8, one replica and two on the card in turns (one, two, two, one):
    depthmaps/s with the readback in the steady window and over the run, and peak
    memory. Every wait on the card is under a ``Deadline``; a bar missed fails the phase
    after every measurement is printed. Returns the launches of (b)'s f32 run and the
    rates."""
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        IN_FLIGHT, StreamingRunner, load_model, make_dataset, model_config_from_params)
    from multi_view_stereonet_tpu_torch.ops.cuda import build
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    failures = []
    ratios = cooperative_grids(dev, smi, failures)

    cfg = load_params_yaml(inputs["params_yaml"])
    config = model_config_from_params(cfg)
    model = load_model(inputs["weights_dir"], dev)
    data_dir, split = inputs["trees"][1]
    datasets = {u8: Cycled(make_dataset(data_dir, split, cfg, "pil", u8_output=u8), 5)
                for u8 in (False, True)}

    def serve_all(runner, u8, batch_size):
        with Deadline(f"the runner on {len(runner.devices)} replica(s) at batch "
                      f"{batch_size}"):
            served = list(runner.run(datasets[u8], batch_size=batch_size, workers=1))
        return (np.concatenate([d for d, _ in served]),
                [n for _, names in served for n in names])

    one, names = serve_all(StreamingRunner(model, config, device=dev), False, 1)
    launches = None
    for u8, fetch, flag in ((False, None, False), (True, None, True),
                            (False, torch.float16, False)):
        torch.backends.cudnn.allow_tf32 = flag
        runner = StreamingRunner(model, config, devices=[dev, dev], fetch_dtype=fetch)
        zero_launches()
        got, got_names = serve_all(runner, u8, 2)
        if launches is None:
            launches = read_launches()
        after = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        ref = one if fetch is None else one.astype(np.float16)
        same = (got.dtype == ref.dtype and got.shape == ref.shape
                and np.array_equal(got.view(np.uint8), ref.view(np.uint8)))
        keys = {(dev.index, r.stream.cuda_stream) for r in runner._replicas}
        counters = len(keys) == 2 and keys <= set(build._barriers)
        what = "f16 fetch" if fetch is not None else "u8" if u8 else "f32"
        log(f"replicas (b): the card named twice, {what}, caller's cuDNN TF32 {flag}: "
            f"{len(got_names)} requests at batch 2 (split, split, the tail whole) "
            f"{'equal to the f32 output cast of' if fetch else 'bit-equal to'} one replica "
            f"at batch 1: {same}; names in order {got_names == names}; a grid-barrier "
            f"counter (K3, K4) a replica stream: {counters}; the flag after the run {after}")
        if not (same and got_names == names and counters and after is flag
                and np.isfinite(got.astype(np.float32)).all()):
            failures.append(f"two replicas, {what}: same {same}, counters {counters}, "
                            f"flag {after}")
    expected = expected_launches([(1, 1)] * len(names))
    log(f"replicas (b): launches of the f32 run {launches} (expected {expected}: five "
        "B=1 forwards)")
    if launches != expected:
        failures.append(f"two replicas launched {launches}, expected {expected}")

    long_data = make_dataset(*inputs["long"], cfg, "pil")
    rates = {1: [], 2: []}
    for k in (1, 2, 2, 1):
        runner = StreamingRunner(model, config, devices=[dev] * k)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        stamps, count = [], 0
        t0 = time.perf_counter()
        with Deadline(f"the LONG tree at B=8 on {k} replica(s)"):
            for _, batch_names in runner.run(long_data, batch_size=8):
                stamps.append(time.perf_counter())
                count += len(batch_names)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        window = np.array(stamps[IN_FLIGHT + 2:len(stamps) - IN_FLIGHT])
        if count != LONG or len(window) < 4:
            failures.append(f"the LONG tree on {k} replica(s): {count} results")
            continue
        steady = 8 * (len(window) - 1) / float(window[-1] - window[0])
        whole = count / (stamps[-1] - t0)
        rates[k].append({"steady": steady, "whole": whole, "peak_gib": peak})
        log(f"replicas (c): {k} replica(s) on the card, B=8 V=1 {H0}x{W0} D={D}: "
            f"{steady:.2f} depthmaps/s with the readback over {len(window) - 1} steady "
            f"steps, {whole:.2f} over the run of {LONG} (loader start-up included), host "
            f"decode with 4 threads; peak memory {peak:.3f} GiB ({smi})")
    if failures:
        raise AssertionError("phase 14: " + "; ".join(failures))
    return {"launches": launches, "k3_two_over_one": ratios, "rates": rates}


def convergence_phase(dev, smi, root):
    """Phase 15: (a) the convergence module (``train/convergence.py``) on Run A's tree and
    recipe (96x128, layered_track, 2 sequences x 10 frames, batch 4) for
    CONV_EPOCHS_TOTAL epochs, stopped after CONV_EPOCHS_FIRST and resumed, on the card:
    epochs and steps continued across the resume, every loss finite, and the launches,
    zeroed just before, those of its train steps' and validation's forwards
    (``expected_launches`` at 96x128: K3 takes refiners 4-1). (b) The ladder
    (``eval/accuracy.py``) over Run A's committed weights on the tree's held-out split,
    every config: the configs at "highest"'s modes bit-equal to it (the ladder raises
    otherwise), and "highest"'s abs_rel and EPE within CONV_ABS_REL_BAR relative of the
    CPU's plain path (``ladder_cpu.json``). Returns the launches and the ladder."""
    from multi_view_stereonet_tpu_torch.eval.accuracy import ladder, split_batches
    from multi_view_stereonet_tpu_torch.eval.streaming import load_model
    from multi_view_stereonet_tpu_torch.train.convergence import (
        hold_out, read_table, run_convergence)

    work = os.path.join(root, "convergence")
    data_dir, split = synthetic_data().make_gta_sfm_tree(
        work, num_sequences=CONV_SEQUENCES, frames=CONV_FRAMES, rows=CONV_SIZE[0],
        cols=CONV_SIZE[1], seed=CONV_TREE_SEED, scene=CONV_TAG)
    zero_launches()
    t0 = time.perf_counter()
    summary = run_convergence(data_dir, split, work, os.path.join(root, "convergence_dest"),
                              size=CONV_SIZE, batch=CONV_B, epochs_first=CONV_EPOCHS_FIRST,
                              epochs_total=CONV_EPOCHS_TOTAL, tag=CONV_TAG, device=dev)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    header, rows = read_table(os.path.join(work, "run", "losses.txt"))
    steps = [int(r[header.index("step")]) for r in rows]
    losses = [float(r[header.index("loss")]) for r in rows]
    val_batches = -(-summary["n_val"] // CONV_B)
    forwards = [(CONV_B, 1)] * (len(steps) + CONV_EPOCHS_TOTAL * val_batches)
    expected = expected_launches(forwards, *CONV_SIZE)
    finite = all(math.isfinite(x) for x in losses)
    log(f"convergence run, Run A's recipe on the card ({smi}): {CONV_EPOCHS_TOTAL} epochs "
        f"resumed after {CONV_EPOCHS_FIRST} in {seconds:.1f} s; {summary['n_train']} train / "
        f"{summary['n_val']} held-out samples, steps {steps[0]}..{steps[-1]} continued "
        f"across the resume (checked by run_convergence); losses finite {finite} "
        f"({losses[0]:.4f} -> {losses[-1]:.4f}); validation EPE "
        f"{summary['table']['first']['epe']:.4f} -> {summary['table']['final']['epe']:.4f}; "
        f"launches {launches} (expected {expected}: {len(steps)} train steps and "
        f"{CONV_EPOCHS_TOTAL * val_batches} validation forwards at B={CONV_B})")
    failures = []
    if not finite:
        failures.append("a non-finite loss")
    if launches != expected:
        failures.append(f"launches {launches}, expected {expected}")

    weights_dir = os.path.join(REPO, "docs", "convergence_torch", CONV_TAG)
    _, val_split, _, _ = hold_out(split, work)
    batches = split_batches(data_dir, val_split, *CONV_SIZE)
    model = load_model(weights_dir, dev)
    t0 = time.perf_counter()
    table = ladder(model, batches, dev, base={"num_idepth_samples": D},
                   time_batch={k: v[:1] for k, v in batches[0].items()}, log=log)
    with open(os.path.join(weights_dir, "ladder_cpu.json")) as f:
        cpu = json.load(f)["rows"]["highest"]
    gaps = {k: abs(table["highest"][k] - cpu[k]) / abs(cpu[k]) for k in ("abs_rel", "epe")}
    log(f"ladder over {weights_dir} on the held-out split ({smi}), {len(table)} configs in "
        f"{time.perf_counter() - t0:.1f} s: highest abs_rel {table['highest']['abs_rel']:.6f}, "
        f"EPE {table['highest']['epe']:.4f}; the CPU's plain path {cpu['abs_rel']:.6f}, "
        f"{cpu['epe']:.4f} (gaps {gaps['abs_rel']:.2e}, {gaps['epe']:.2e}, bar "
        f"{CONV_ABS_REL_BAR:.0e}); bit-equal to highest: "
        f"{[n for n, r in table.items() if r['same_modes_as'] == 'highest']}")
    if max(gaps.values()) > CONV_ABS_REL_BAR:
        failures.append(f"highest against the CPU's plain path {gaps}")
    if failures:
        raise AssertionError("phase 15: " + "; ".join(failures))
    return {"launches": launches, "ladder": table}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an "
                         "NVIDIA card")
    sys.path.insert(0, REPO)
    from multi_view_stereonet_tpu_torch.ops.cuda import build

    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    sources = ("warp", "incremental_chain", "idepthmap_refiner", "gn_apply")
    t0 = time.perf_counter()
    build.load_libraries(*sources)
    log(f"build {', '.join(s + '.cu' for s in sources)} (parallel): "
        f"{time.perf_counter() - t0:.2f} s")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return result

    with torch.inference_mode():
        kernels = phase("3 (kernels)", check_kernels, dev)
    backward = phase("3b (backward)", check_backward, dev)
    # Phase 12 (a) runs here, early in the process like 3b: later in a long run,
    # torch.profiler was seen to miss most of a backward's kernel events.
    backward_bf16 = phase("12 (a) (backward at bf16)", check_backward, dev, torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = write_inputs(tmp)
        launches, ms, worst, served = phase("4 (serving)", serve, dev, inputs)
        log(f"serving ms/frame B=1 V=1 480x640 D=12 ({smi}): kernels {ms['auto']:.3f}, "
            f"plain {ms['plain']:.3f}; worst serving error {worst:.3e} of range")
        phase("5 (eval)", evaluate, dev, inputs, smi)
        phase("6 (transport)", transport, dev, inputs, smi)
        train_launches, trained = phase("7 (train)", train_phase, dev, inputs, smi)
        two_view_step, two_view = phase("8 (two-view train)", two_view_phase, dev, inputs,
                                        smi)
        artifact = phase("9 (weights and artifact)", artifact_phase, dev, inputs, smi)
        multi = phase("10 (multi-process training)", multi_process_phase, dev, inputs, smi,
                      trained["cli_ms"])
        bf16 = phase("11 (bf16 serving)", bf16_phase, dev, inputs, smi, kernels)
        bf16_train = phase("12 (bf16 training)", bf16_train_phase, dev, inputs, smi, trained,
                           backward_bf16)
        tf32 = phase("13 (matmul precision)", precision_phase, dev, inputs, smi, served)
        replicas = phase("14 (replicas)", replica_phase, dev, inputs, smi)
        convergence = phase("15 (convergence and the ladder)", convergence_phase, dev, smi,
                            tmp)
    log(f"train B={TRAIN_B} V=1 {H0}x{W0} D={D} ({smi}): kernel path "
        f"{trained['ms']['auto']:.3f} ms a step, {trained['images_s']['auto']:.2f} images/s, "
        f"peak {trained['peak_gib']['auto']:.3f} GiB; plain path {trained['ms']['plain']:.3f} "
        f"ms, {trained['images_s']['plain']:.2f} images/s, peak "
        f"{trained['peak_gib']['plain']:.3f} GiB; the CLI loop {trained['cli_ms']:.3f} ms a "
        f"step, the loader alone {trained['loader_ms']:.3f} ms a batch")
    b1, b8 = bf16["timing"]["B=1"], bf16["timing"]["B=8"]
    log(f"bf16 serving B=1 V=1 {H0}x{W0} D={D} ({smi}): ms/frame bf16 "
        f"{statistics.median(b1['ms_frame']['bf16']):.3f} vs f32 "
        f"{statistics.median(b1['ms_frame']['f32']):.3f} (B=8: "
        f"{statistics.median(b8['ms_frame']['bf16']):.3f} vs "
        f"{statistics.median(b8['ms_frame']['f32']):.3f}); worst level deviation from f32 "
        f"(max, mean) % of range "
        f"{100 * max(m for d in bf16['deviation'].values() for m, _ in d):.3f}, "
        f"{100 * max(a for d in bf16['deviation'].values() for _, a in d):.4f}; eval "
        f"abs_rel bf16 {bf16['abs_rel']['bf16']:.4f} vs f32 {bf16['abs_rel']['f32']:.4f}")
    log(f"two-view train B={TRAIN_B} {H0}x{W0} D={D}, every loss ({smi}): kernel path "
        f"{two_view['ms']['auto']:.3f} ms a step, peak {two_view['peak_gib']['auto']:.3f} GiB; "
        f"plain path {two_view['ms']['plain']:.3f} ms, peak "
        f"{two_view['peak_gib']['plain']:.3f} GiB; launches a step {two_view_step}; kernel "
        f"vs plain loss {two_view['loss_gap']:.2e}, worst gradient {two_view['grad_err']:.3e}")

    ms12, peak12 = bf16_train["ms"], bf16_train["peak_gib"]
    log(f"bf16 train B={TRAIN_B} V=1 {H0}x{W0} D={D} ({smi}): kernel path "
        f"{ms12['auto bf16']:.3f} ms a step ({bf16_train['images_s']['auto bf16']:.2f} "
        f"images/s) against f32 {ms12['auto f32']:.3f}, plain path {ms12['plain bf16']:.3f} "
        f"against {ms12['plain f32']:.3f}; peak {peak12['auto bf16']:.3f} GiB against "
        f"{peak12['auto f32']:.3f}; device busy {bf16_train['busy_ms']['auto bf16']:.3f} ms "
        f"a step against {bf16_train['busy_ms']['auto f32']:.3f}; kernel vs plain at bf16: "
        f"loss {bf16_train['loss_gap']:.2e}, flat gradient {bf16_train['grad_gap']:.3e}")

    pkg = "multi_view_stereonet_tpu_torch"
    report = {"kernels": [
        {"name": "grid_sample", "route": "cuda", "source": f"{pkg}/csrc/warp.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/warp_kernel.py:270",
         "launches": launches["warp"], "train_launches": train_launches["warp"],
         "two_view_launches": two_view_step["forward"]["warp"],
         "artifact_launches": artifact["launches"]["b1"]["warp"],
         "artifact_launches_b24": artifact["launches"]["b24"]["warp"],
         **artifact["dispatch"]["warp"],
         "multi_process_launches": multi["per_step"]["warp"],
         "replica_launches": replicas["launches"]["warp"],
         "convergence_launches": convergence["launches"]["warp"],
         **kernels["warp"], "bf16": {**bf16["kernels"]["warp"],
                                     "launches": bf16["launches"]["warp"]},
         "bf16_train_launches": bf16_train["launches"]["warp"],
         "bf16_backward": bf16_train["backward"]["K1"],
         "backward": {**backward["K1"], "loss_shapes": [backward["K1 C=1"],
                                                        backward["K1 C=3"]]}},
        {"name": "incremental_chain", "route": "cuda",
         "source": f"{pkg}/csrc/incremental_chain.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/incremental_chain.py:224",
         "launches": launches["chain"], "train_launches": train_launches["chain"],
         "two_view_launches": two_view_step["forward"]["chain"],
         "artifact_launches": artifact["launches"]["b1"]["chain"],
         "artifact_launches_b24": artifact["launches"]["b24"]["chain"],
         **artifact["dispatch"]["chain"],
         "multi_process_launches": multi["per_step"]["chain"],
         "replica_launches": replicas["launches"]["chain"],
         "convergence_launches": convergence["launches"]["chain"],
         **kernels["chain"], "bf16": {**bf16["kernels"]["chain"],
                                      "launches": bf16["launches"]["chain"]},
         "bf16_train_launches": bf16_train["launches"]["chain"],
         "bf16_backward": bf16_train["backward"]["K2"],
         "tf32": {**tf32["kernels"]["chain"], "launches": tf32["launches"]["chain"],
                  "train_launches": tf32["train_launches"]["chain"]},
         "backward": backward["K2"]},
        {"name": "idepthmap_refiner", "route": "cuda",
         "source": f"{pkg}/csrc/idepthmap_refiner.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py:213",
         "launches": launches["refiner"], "train_launches": train_launches["refiner"],
         "two_view_launches": two_view_step["forward"]["refiner"],
         "artifact_launches": artifact["launches"]["b1"]["refiner"],
         "artifact_launches_b24": artifact["launches"]["b24"]["refiner"],
         **artifact["dispatch"]["refiner"],
         "multi_process_launches": multi["per_step"]["refiner"],
         "replica_launches": replicas["launches"]["refiner"],
         "convergence_launches": convergence["launches"]["refiner"],
         **kernels["refiner"], "bf16": {**bf16["kernels"]["refiner"],
                                        "launches": bf16["launches"]["refiner"]},
         "bf16_train_launches": bf16_train["launches"]["refiner"],
         "bf16_backward": bf16_train["backward"]["K3"],
         "tf32": {**tf32["kernels"]["refiner"], "launches": tf32["launches"]["refiner"],
                  "train_launches": tf32["train_launches"]["refiner"]},
         "backward": backward["K3"]},
        {"name": "group_norm_act", "route": "cuda", "source": f"{pkg}/csrc/gn_apply.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/gn_apply.py:72",
         "launches": launches["gn_apply"], "train_launches": train_launches["gn_apply"],
         "two_view_launches": two_view_step["forward"]["gn_apply"],
         "artifact_launches": artifact["launches"]["b1"]["gn_apply"],
         "artifact_launches_b24": artifact["launches"]["b24"]["gn_apply"],
         **artifact["dispatch"]["gn_apply"],
         "multi_process_launches": multi["per_step"]["gn_apply"],
         "replica_launches": replicas["launches"]["gn_apply"],
         "convergence_launches": convergence["launches"]["gn_apply"],
         **kernels["gn_apply"], "bf16": {**bf16["kernels"]["gn_apply"],
                                         "launches": bf16["launches"]["gn_apply"]},
         "bf16_train_launches": bf16_train["launches"]["gn_apply"],
         "bf16_backward": bf16_train["backward"]["K4"],
         "backward": backward["K4"]},
        {"name": "group_norm_act_backward", "route": "cuda",
         "source": f"{pkg}/csrc/gn_apply.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/gn_apply.py:120 (_bwd: the VJP of "
                     "the XLA reference; no TPU kernel)",
         "launches": trained["backward_launches"]["gn_apply"],
         "step_launches": trained["step_backward_launches"]["gn_apply"],
         "max_abs_err": backward["K4 kernel"]["max_abs_err"],
         "max_rel_err": backward["K4 kernel"]["max_rel_err"],
         **{k: backward["K4 kernel"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "gn_route", "blocks",
                                                   "kink_elements")},
         "function_ms": backward["K4"]["ms"], "autograd_ms": backward["K4"]["plain_ms"],
         "bf16": backward_bf16["K4 kernel"]},
        {"name": "grid_sample_backward", "route": "cuda", "source": f"{pkg}/csrc/warp.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/warp_kernel.py:396 "
                     "(_pallas_grid_sample_bwd: the VJP of the XLA gather; no TPU kernel)",
         "launches": two_view["backward_launches"]["warp"],
         "step_launches": two_view_step["backward"]["warp"],
         "train_launches": trained["backward_launches"]["warp"],
         **{k: backward["K1 kernel"][k] for k in (
             "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shapes")},
         "function_ms": backward["K1"]["ms"], "autograd_ms": backward["K1"]["plain_ms"],
         "step_calls": backward["K1 step"]["shapes"],
         **{k: backward["K1 step"][k] for k in ("step_ms", "step_bound_ms",
                                                 "step_library_ms")},
         "bf16": backward_bf16["K1 kernel"]},
        {"name": "incremental_chain_backward", "route": "cuda",
         "source": f"{pkg}/csrc/incremental_chain.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/incremental_chain.py:357 "
                     "(_chain_bwd: the VJP of the XLA scan; no TPU kernel)",
         "launches": trained["backward_launches"]["chain"],
         "step_launches": trained["step_backward_launches"]["chain"],
         "two_view_launches": two_view_step["backward"]["chain"],
         **{k: backward["K2 kernel"][k] for k in (
             "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "shapes")},
         "library_ms": None,
         "function_ms": backward["K2"]["ms"], "autograd_ms": backward["K2"]["plain_ms"],
         "bf16": {**backward_bf16["K2 kernel"], "function": backward_bf16["K2"]},
         "tf32": tf32["kernels"]["chain_backward"]},
        {"name": "idepthmap_refiner_backward", "route": "cuda",
         "source": f"{pkg}/csrc/idepthmap_refiner.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py:244 "
                     "(_fused_bwd: the VJP of idepthmap_refiner_s2d; no TPU kernel)",
         "launches": trained["backward_launches"]["refiner"],
         "step_launches": trained["step_backward_launches"]["refiner"],
         "two_view_launches": two_view_step["backward"]["refiner"],
         **{k: backward["K3 kernel"][k] for k in (
             "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "recompute_ms", "shapes")},
         "library_ms": None,
         "function_ms": backward["K3"]["ms"], "autograd_ms": backward["K3"]["plain_ms"],
         "bf16": {**backward_bf16["K3 kernel"], "function": backward_bf16["K3"]},
         "tf32": tf32["kernels"]["refiner_backward"]},
        {"name": "incremental_chain_wgrad", "route": "cuda",
         "source": f"{pkg}/csrc/incremental_chain.cu",
         "header": f"{pkg}/csrc/wgrad.cuh",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/incremental_chain.py:357 "
                     "(_chain_bwd: the VJP of the XLA scan; no TPU kernel), its weight "
                     "gradients",
         "launches": trained["wgrad_launches"]["chain"],
         **{k: backward["K2 wgrad"][k] for k in (
             "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "shapes")},
         "library_ms": None, "bf16": backward_bf16["K2 wgrad"]},
        {"name": "idepthmap_refiner_wgrad", "route": "cuda",
         "source": f"{pkg}/csrc/idepthmap_refiner.cu",
         "header": f"{pkg}/csrc/wgrad.cuh",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py:244 "
                     "(_fused_bwd: the VJP of idepthmap_refiner_s2d; no TPU kernel), its "
                     "weight gradients",
         "launches": trained["wgrad_launches"]["refiner"],
         **{k: backward["K3 wgrad"][k] for k in (
             "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "shapes")},
         "library_ms": None, "bf16": backward_bf16["K3 wgrad"]},
    ]}
    log(json.dumps(report))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
