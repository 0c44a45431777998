#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpusr_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card with sm_90a, the CUDA
toolkit (``nvcc``) and no network. It imports no JAX. Phases, each printing
its own lines:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, the TF32 flags (off);
2. build: every CUDA source of the port, one ``nvcc`` per source, in parallel;
3. K1 (``conv3x3_int8_requant``, int8 tensor cores) against its plain twin
   at each shape the serving path launches it at (13 trunk layers at the
   batch from 560x560, the 11 per-patch layers of blocks 2-5 at the
   escalated patches from 48x48, and the same 11 at the guard fallback's
   1600 patches, totalled on a line of their own): bit-equal, with the
   achieved TOP/s and share of the bound per shape, ``torch._int_mm`` on a
   prebuilt im2col as a yardstick for the GEMM alone (``gemm_library_ms``)
   and the SM clock and power under load at the deepest trunk shape;
4. K3 (``block1_int8``, fused patch extraction + block 1 + pool, both
   convs on the int8 tensor cores) against its plain twin at the
   escalation's 4 images of 512^2 (400 patches), the guard fallback's 16
   (1600 patches) and one 128^2 image (4 patches): 0 differing int8 values
   and equal to patch extraction + two K1 launches + the pool, timed beside
   that path, with the achieved TOP/s and share of the bound; the tensor-core
   and dp4a instructions in the kernel's SASS (``cuobjdump``) and any ptxas
   warning about its wgmma;
5. K2 (``conv3x3_bias_act``, f32) against its plain twin at the EDSR body
   shapes and the border-band slab shapes: max |err| <= 1e-4 (fp32 sums in
   another order), with ``F.conv2d`` fp32 timed beside it as the library
   yardstick, the achieved TFLOP/s and share of the bound per shape, and
   images 0-1 of the body conv's 16-image output bit-equal to a 2-image
   launch (batch invariance);
6. K2's bf16 instance (tensor cores) against its twin at the same shapes:
   within the derived bound of ``check_k2_bf16`` (one bf16 ulp plus the
   worst case of two fp32 sums in any order), ``F.conv2d`` bf16 as the
   yardstick, the same rates and batch-invariance check;
7. K4 (``nlm_denoise``) against its twin at 128^2 (the LR size the classic
   comparison denoises) and 512^2, 1024^2, 2048^2: ``allclose`` at atol
   1e-5 (exp weights and sums in another order), bit for bit on a repeat
   at 128^2 and 2048^2, no spill in nlm.cu's ``-Xptxas -v`` lines, at
   least one block per SM at 128^2; timed as a wrapper call (``ms``) and
   as a bare launch replayed from a CUDA graph (``kernel_ms``) at both
   launch configurations;
8. the serving slice at full width: EDSR x4 (16 blocks, 64 filters) and
   VGG16 (2 classes) from ``--seed``, the classifier's last bias centered so
   both classes get votes, the shipped mode (f32 fused SR -> guarded
   vote_frac int8 cascade) served by ``PipelineServer`` at batch 16 for 20
   requests, with the launch counts the path implies (a per-patch call
   launches K3 once and K1 11 times), the SR held against a plain chained
   EDSR, the int8 stage held against the same stage on K1's and K3's twins,
   the K3 per-patch probabilities held equal to the all-K1 path, and the
   guard-tripped cascade held against that all-K1 per-patch path;
9. bf16 SR serving: one batch of 16 through ``make_serving_pipeline(
   sr_mode="bf16", cascade_int8, vote_frac, frac 0.28125, guard 0.6)`` on
   the same weights, with 46 K2-bf16 launches, its SR against the f32 SR
   and its classes against the f32-SR cascade;
10. int8 SR serving: ``conv3x3_int8_dequant`` against its twin at its
   shapes (bit-equal; TOP/s, share of bound and the ``_int_mm`` GEMM
   yardstick as for K1) and the ``torch._int_mm`` 7x7 tail against its
   float64 twin (equal); then one batch of 16 of each of bench.py's int8-SR
   rows (``int8_sr_per_patch_int8``, ``int8_sr_shared_trunk_int8``,
   ``int8_sr_noborder_shared_trunk_int8``) with their launch counts, the SR
   held bit for bit against the same SR on the dequant conv's twin, and
   its PSNR against the f32 SR;
11. the f32 modes: one batch of ``shared_trunk_f32`` (its patch
   probabilities against a float64 run of the same trunk), one of
   ``per_patch_f32`` with ``classify_chunks=4`` against ``classify_chunks
   =1``, and one call of ``tpusr_torch.entry.entry()``;
12. the classic-SR comparison: ``run_classic_comparison`` on 16 HR 512^2 /
   LR 128^2 uint8 pairs made from ``--seed``, with the K4 launches it
   implies, the reference's score pattern, and one pair's SR images held
   against the same harness run on the CPU (plain twins);
13. patch and full-image SR (``pipeline/inference.py``, ``InferenceSlice``)
   on one 128^2 LR image at full width from ``--seed``: EDSR x4 by
   ``super_resolve_image`` at patch 48, stride 24 (37 K2 launches), SRCNN by
   ``srcnn_super_resolve`` to 512^2 (no kernel), the ESRGAN generator at
   ``ESRGANConfig`` (growth 8, 4 RRDB, x2) by patches (65 launches) and by
   ``super_resolve_full_image`` at attention block 4096, and at growth 32,
   23 RRDB on the full image (350 launches); each path's output in [0, 1]
   at its shape, bit for bit the same on a second call, against the same
   call on K2's plain twin (EDSR at ``SR_ATOL``; ESRGAN g8 at 1/2 x launches
   x ``K2_ATOL``; g32x23 in two parts from inputs shared with the twin,
   ``check_chaotic_generator``: its trunk at its launches x ``K2_ATOL``
   against the twin and a float64 run, its tail from the twin's trunk no
   further from float64 on average than 2x the twin's, the output's
   distances from a float64 run reported),
   every K2 launch within its per-output bound
   (``k2_forward_bound``) against the twin on its own input, and no plain twin
   on the card; it prints each call's ``time_sec`` and ``gpu_peak_mb`` and
   K2's ms at every shape of these paths beside ``F.conv2d`` fp32;
14. the trainers at the serving gate's shapes (``TrainSlice``): the K2
   autograd Function (``conv3x3_bias_act_train``) against autograd through
   the plain twin at every conv of an EDSR x4 training step (dX within
   ``k2_f32_bound``, Cin 256 at up0/up1; dW, db within 1e-5 of their max),
   3 steps on K2 against 3 on the twin (losses rtol 1e-4); then 20
   ``SupervisedSRTrainer`` steps of EDSR x4 at batch 16 of LR 32^2 (73 K2
   launches a step, 37 an eval step, a falling loss), 10
   ``ClassifierTrainer`` steps of VGG16 at batch 64 of 96^2 with dropout
   (finite losses), a 2-epoch ``fit`` with a checkpoint each epoch,
   restored and evaluated, and no plain twin called on the card; the median
   step ms, peak memory, a ``torch.profiler`` breakdown of each step and K2's ms
   at the training shapes beside ``F.conv2d`` and ``conv2d_input``;
15. the adversarial ESRGAN trainer (``GanSlice``: ``ESRGANConfig``'s growth
   8, 4 RRDB, x2, batch 16 of LR 24^2 -> HR 48^2, the full VGG19 to
   ``block5_conv4``): the G step on K2 against the twin at each of its 65
   convs on the input and output gradient recorded in the step
   (``k2_backward_case``: dX within ``k2_f32_bound``, dW and db within 1e-5
   of their max), the whole G gradient against the twin's and a float64
   witness's (reported per leaf), and 3 steps on K2 against 3 on the twin
   (losses rtol 1e-4); then 20
   steps (129 K2 launches each: 65 forward + 64 dX; step median by the host
   clock, CUDA-event ms, device busy and idle share, peak memory; a
   ``profiling.trace`` of one step and ``time_compiled`` val steps), the
   ``ESRGAN`` facade's 2-epoch fit, evaluate, save and ``from_trained`` (the
   restored generator's SR byte-equal), a 2-epoch trainer fit with a
   checkpoint each epoch, restored, and no plain twin on the card; 3 steps
   with ``remat`` (194 launches, the same bits, a lower peak); 3 bf16 steps
   (129 K2-bf16 launches, every dX within ``k2_bf16_tolerance`` of its
   twin); 3 steps at the facade's default growth 32, 23 RRDB; K2's and
   K2-bf16's ms at the training shapes beside ``F.conv2d`` +
   ``conv2d_input``;
16. the serving gate (``GateSlice``): ``tools/serving_gate.run_gate`` on one
   seed of the hard task at the full protocol (64 training and 128 eval
   images of 512^2, VGG16 500 steps at batch 64, EDSR x4 600 steps at batch
   16, all nine modes and every derived cascade row), with the launches the
   modes imply, no plain twin called on the card, finite losses and a
   falling EDSR loss, the derived rows equal to their recompute from the
   report's raw votes and a report that round-trips through json; it prints
   the training times, every mode's agreement, the SR drifts and the
   shipped row. Then, on the gate's trained weights, the shipped mode
   serves the 128 eval images through ``PipelineServer`` at batch 16 (guard
   trips, agreement with the gate's reference classes, ms per batch with
   the guard on and off), and ``run_defect_detection_comparison`` runs
   bicubic and EDSR f32, bf16 and int8 on 32 eval images with the per-patch
   int8 classifier;
17. the HTTP serving tier on the gate's trained weights: the trained EDSR
   and VGG16 saved by the facades (``models/api.py``), 16 calibration LR
   images drawn as the gate draws its eval set (another seed) written as
   PNG by the port's codec, ``python -m tpusr_torch.cli serve`` in its
   default mode on a thread (``--port 0``, ``--max-requests``); /healthz
   with the gate note from ``GATE_torch.json``; the 128 eval LR images as
   PNG to /classify at client concurrency 1 and 16, with the K1, K2 and K3
   launches the batches imply, classes against the gate's reference at >=
   99%, request latency p50/p99 on the client's clock, requests/s, batches
   formed, mean fill, queue wait and batch time; 8 /sr answers byte for
   byte the pipeline's direct SR of the image beside 15 other eval images;
   the committed 128^2 LR bodies in progressive JPEG, Adam7 PNG, BMP,
   TIFF, lossy and lossless WebP and GIF (``tests/data/formats``), 8 of
   each to /classify and /sr at concurrency 1, and one PPM and one HDR to
   /classify, answered as the PNG twins of their decodes (classes equal,
   /sr byte for byte), with the launches their batches imply; 400 for a
   non-image and a truncated JPEG
   body, 404 for another path; the command's exit after its last request;
18. the reference's commands (``CommandsSlice``) on its own dataset
   layout, made on the card: 16 HR print surfaces of 512^2 (the gate's hard
   task) and their x0.25 ``degrade_image`` LR as PNG with
   ``interp_map.pkl`` and ``class_map.pkl``, and 16 more as the prediction
   set; then, through ``tpusr_torch.cli.__main__.main`` in process,
   ``train-edsr --scale 4`` (2 epochs, 1600 pairs split 1120/160/320),
   ``train-srcnn`` (1 epoch), ``train-vgg16`` (2 epochs, 81 patches an
   image), ``train-esrgan --scale 4`` (1 epoch, full VGG19), ``classic`` and
   ``pipeline`` on the four checkpoints (ESRGAN's dense attention, so 2
   images a batch); each command's files, wall time, steps/s, split, eval
   loss and PSNR or accuracy, K2, K2-bf16 and K4 launches (K2 as the split
   and the per-step launches imply, K4 as ``phase_classic``'s 49), peak
   memory, no plain twin on the card, every trained state finite; the
   pipeline's EDSR SR of its first batch against K2's twin (every launch
   within ``k2_forward_bound``, the SR at ``SR_ATOL``); and one
   ``python -m tpusr_torch.cli train-edsr --help`` subprocess; ``classic``
   and ``pipeline`` with their figures (``figure_stage``,
   ``check_figures``): the JAX commands' files, each decoding at figsize x
   dpi, no axes holding data blank, one colormapped panel equal to its
   data mapped on the host, no kernel launched by the figure stage, its ms
   per figure, the files' bytes and the device's share;
19. the parallelism layer (``DistSlice``, ``tpusr_torch/dist``), after
   phase 17 on the gate's trained weights: at NCCL world size 1, 20
   data-parallel EDSR x4 steps (median ms beside phase 14's), DP VGG16
   with dropout, the DP GAN step, the shipped mode DP at batch 16 with 3
   pad rows, ``super_resolve_full_image(mesh=)`` of g8x4 x4 at 128^2 (halo
   slabs, the ring) and the PP step of 16 blocks in 1 stage at 4
   microbatches, each against its unsharded run, with their launches; every
   halo-slab and PP-microbatch K2 launch held against the twin; then 2 gloo
   ranks sharing the card (DP EDSR x4 gradients, the served classes, TP on
   a (1, 2) mesh: forward and step, each TP shape held), which carry no
   send/recv of CUDA tensors, so PP and SP over 2 ranks run in the CPU
   tests only (a line says so); K2 at the new shapes beside ``F.conv2d``;
20. the ``eda`` command (``EdaSlice``): the JPEG decoder against cv2's
   decode of every committed fixture (``tests/data/jpeg``: sha256 and PNG
   twins; the progressive one included) and timed at 128^2 and 512^2; 16
   HR 512^2 / LR 128^2 surfaces made as phase 18 makes them plus the
   committed JPEG pair, ``python -m tpusr_torch.cli eda`` in process with
   LPIPS-alex on seeded random weights: no kernel launched, no plain twin,
   both CSVs finite and whole, the pick by LPIPS, the card's rows against a
   CPU run of three pairs (rtol 1e-4, LPIPS within 1e-4), ms per pair split
   into decode, LPIPS and the rest; its figures checked as phase 18's;
21. the uncomposed polyphase SR path (``PolySlice``,
   ``edsr_fast.make_poly_sr_apply``): EDSR x4 at full width on 16 LR 128^2
   images in f32 and bf16, 36 launches a forward (K2 or K2-bf16), every
   launch within its bound of the twin (``k2_forward_bound``, bf16
   ``k2_bf16_tolerance``), f32 at ``SR_ATOL`` of ``edsr.forward``, bf16 by
   PSNR, each timed beside the fused path; K2's ms at the path's shapes
   beside ``F.conv2d``;
22. Winograd F(2x2, 3x3) (``WinogradSlice``, ``core/winograd.py``) at VGG16
   blocks 2-4 on 64 patches of 96^2: f32 against a float64 conv and int8
   against the exact conv of its int8 input, each within
   ``winograd_bounds``, timed beside ``F.conv2d`` fp32 and the direct int8
   dequant conv (the TPU's negative result, measured on the card);
23. the Keras ``.h5`` codec (``H5Slice``, ``train/hdf5.py``,
   ``keras_export.py``, ``keras_import.py``) at full width: the committed
   fixtures (``tests/data/keras``) read without h5py, equal to the manifest
   h5py wrote; EDSR x4, the g32x23 generator and the discriminator at 96^2,
   SRCNN and VGG16 through ``save_h5`` and ``from_pretrained``/
   ``from_trained`` on the ``.h5``, their outputs (the generator's trunk
   and SR, the discriminator's logits and ``u``) torch.equal to the
   source's; the shipped mode served on the imported EDSR and VGG16 (K1,
   K2, K3 held to their twins); ``cli convert`` of the four models,
   checkpoint -> ``.h5`` -> checkpoint, every tensor equal; ``train-esrgan
   --vgg19-weights`` on a VGG19 notop ``.h5`` against the same weights as
   ``.npz`` (first step's losses equal; K2 forward and dX held as in 18);
   the ImageNet tool's ``.h5`` -> ``.npz``; each file's size, write and
   read ms;
24. ``preprocess`` (``PreprocessSlice``, ``data/video.py``): the JPEG
   encoder's bytes, the MJPEG-AVI reader's rate, count and frames and
   ``resize_u8`` on the card against the cv2 fixtures in
   ``tests/data/video``; the crop, resize and degradation on the card
   against the CPU on the same draws (the core within 1e-5, the PNGs equal
   but where a value rounds apart at uint8); ``cli preprocess`` on the
   1280x720 clip with ``--hr-size 512`` and without and on the odd-width
   clip, timed per frame by stage; ``train-edsr --scale 2`` on its pairs
   with its first step held against K2's twin;
25. the image formats (``FormatsSlice``, ``pipeline/imdecode.py``): every
   committed fixture in ``tests/data/formats`` (PNG, Adam7 and low-depth
   PNG, baseline, progressive, SOF1, RGB, CMYK, YCCK and 4:1:1 JPEG, BMP
   with RLE, TIFF in strips, tiles and planes; WebP lossy, lossless, with
   alpha and animated, GIF, PBM/PGM/PPM/PAM, Sun raster, HDR, PFM) decoded
   and held against the sha256 of cv2's decode in its manifest; the decode
   of one 512^2 image in each format timed (host clock, best of 3), and of
   a 128^2 and a 512^2 one in each format only the HTTP tier reads (best of
   2; the PPM, PAM, Sun raster, HDR and PFM bodies written here and held to
   their pixels); ``classic --limit
   4`` on 4 PNG pairs made as phase 18 makes them and on their ``.tiff``
   and ``.bmp`` twins, the JSON (times and memory aside) and K4's launches
   equal to the PNG run's;
26. JAX's random streams on K5 (``PrngSlice``, ``core/prng.py``,
   ``csrc/prng.cu``, run right after the build): ``bits``, ``uniform``,
   ``randint``, ``bernoulli``, ``normal``, ``normal_erf_inv``,
   ``truncated_normal`` and ``permutation`` drawn by K5 at several keys and
   shapes, each torch.equal to the plain version on the card and to the
   CPU's draw (normals within ``PRNG_NORMAL_ULP``, which is 0, as
   ``tests/test_torch_prng.py`` holds the CPU's to JAX's), with one launch
   a draw; both normal samplers over all 2^23 mantissas (K5 on words, the
   plain version on the card, the CPU's tables); all 100.7 M threefry words
   and normals of the gate's (128, 512, 512, 3) surface noise against the
   plain version on the card; K5's ms at the gate's noise, a VGG16
   kernel's truncated normal and a batch's ``randint`` beside the plain
   version's and ``torch.randn``'s (another function, a yardstick only),
   and its bound from the instructions of the normal sampler's loop in
   SASS, by pipe and by issue;
27. the JAX package's Orbax checkpoints (``OrbaxSlice``, ``train/zstd.py``,
   ``ocdbt.py``, ``zarr.py``, ``orbax.py``, ``checkpoint.py``,
   ``bridge.py``): the committed JAX-written fixtures (``tests/data/orbax``:
   SRCNN, EDSR x2, VGG16 with a frozen base, an ESRGAN ``GANState``, two
   JAX steps each) restored onto the card, each network's output on the
   fixture's input within ``SR_ATOL`` (VGG16 ``TRUNK_F32_ATOL``) of JAX's
   stored one; EDSR x4 and VGG16 after training steps (every moment not
   zero), ESRGAN g32x23 with its discriminator and SRCNN saved by the port's
   writer and restored, every tensor torch.equal; the shipped mode served
   on the restored EDSR and VGG16 (K1, K2, K3 held to their twins);
   ``python -m tpusr_torch.cli pipeline --edsr-ckpt <dir> --vgg16-ckpt
   <dir>`` and ``train-edsr --resume <dir> --epochs 1`` (Adam's count goes
   on); each save and restore time and the zstd decode rate on the card and
   on the host's CPU;
28. the models' initial weights on the card (``InitSlice``,
   ``models/init.py``, run right after phase 26): EDSR x4, SRCNN, VGG16
   (2 classes, 256 units), VGG19 to ``block5_conv4``, the ESRGAN generator
   at g32x23 and at ``ESRGANConfig`` and the discriminator, each built at
   full width on the card (one K5 launch a drawn leaf, no other kernel)
   and drawn on the CPU then moved, host ms of each (synchronised, best of
   3), every leaf torch.equal between the two; then a fresh process of
   this script (``--init-probe card``) that builds all seven on the card
   and must build no CPU normal table, make no plain draw and leave torch's
   CPU generator where it was, and one (``--init-probe cpu``) that builds
   the gate's two models the parent's way, timed beside it.

Every path that draws on the card counts K5's launches (``prng`` in the
launch counts): the gate's surfaces, crop pools, batches and dropout masks,
its seed-6 trajectory (``gate_trajectory``: 300 steps of the gate's VGG16
loop, steps 0-2 within ``TRAJ_ATOL`` of JAX's on the CPU from
``tests/data/gate_trajectory/jax_cpu.json``, and the step where it leaves
the ln 2 plateau beside JAX's), phase 14's VGG16 dropout, the calibration
and reference-dataset surfaces, ``train-vgg16``, DP VGG16 and
``preprocess``'s degradations; every other path counts 0, and no plain
draw runs on the card (``count_plain_calls``). From phase 28 on, every
model built on the card launches K5 once a drawn leaf
(``watch_model_builds`` holds each build to its ``drawn_leaves``); a path
that builds a model inside its counted window expects those launches, and
each phase's appear in K5's ``launches_by_path`` as ``init_<phase>``
beside phase 28's ``init``.

``python3 chip_smoke.py --dist-cards N`` (N cards) runs only the
parallelism layer over N NCCL ranks, one card each: DP EDSR x4 at a global
batch of 16 and of 16 a rank (the gradient all-reduce timed alone), the PP
step over N stages, full-image SR of g8x4 x4 and g32x23 x2 with the rows
split (per-rank peak; g32x23 held as ``check_chaotic_generator`` holds the
dense one), then ``tpusr_torch.entry.dryrun_multichip(N)``.

Phase 8 also prints which stage of the fused f32 SR first differs between
an image alone (N = 1) and the same image in the batch of 16, each stage
run on shared inputs (``sr_stage_diffs``). Each path (8-25, 27) is driven with
the launch counts set to 0 just before it and read just after (23: each
of its main-path runs, summed; 24: each ``preprocess`` run (K5 alone)
and the training run; 25: its three ``classic`` runs, summed; 27: the
fixtures' forwards and the served batch, summed). Before the last line it prints one JSON object with a
record per kernel (times: K1, K2 and K3 for one served batch of 16 on the
path without the guard fallback, K2-bf16 the same on the bf16 path, the
dequant conv for one int8-SR batch, K4 one launch at 128^2, as a call
and as a bare launch; ``launches`` counts the kernel's path; K2's record
carries a ``train`` object, one EDSR x4 train step's forward and dX
launches with ``launches`` over the training path, and a ``gan`` object,
one GAN step's at g8x4 with ``launches`` over the GAN path (and the g32x23
step's times); K2-bf16's record a ``train`` object, one bf16 GAN step's; every record's
``gate_launches`` counts the serving gate's run, ``launches_by_path``
every path's launches by name; K2's record carries an ``inference`` object,
its ms, bound and ``F.conv2d`` ms summed over each SR path's launches, and
a ``poly`` object, phase 21's launches, forward ms beside the fused path's
and K2's sums at its shapes; ``launches_by_path`` also has ``eda``,
``poly``, ``h5``, ``orbax``, ``preprocess`` and ``formats``) and the
``nvidia-smi`` line; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12,
                  # special-function unit (expf): 16 results per clock per
                  # SM (NVIDIA's CUDA C++ throughput table, compute
                  # capability 9.0), 132 SMs at the 1.98 GHz boost clock
                  "sfu": 16 * 132 * 1.98e9,
                  # 32-bit integer add, logic and shift: 64 results per
                  # clock per SM (the same table), as thread instructions
                  # on the ALU pipe; the FMA pipes take twice that
                  "int32": 64 * 132 * 1.98e9}
K2_ATOL = 1e-4       # fp32 sums of up to 9*64 terms in another order
K2_BF16_ULPS = 1     # the two outputs' roundings to bf16 at the store
# worst-case error of an fp32 sum of K terms in any order, per term and per
# unit of sum(|x||w|): (K - 1) * 2^-24, doubled for a tensor core that
# truncates when it aligns its addends
FP32_SUM_UNIT = 2.0 ** -23
K4_ATOL = 1e-5       # box sums and exp weights in another order than the twin
SR_ATOL = 1e-4       # fused polyphase tail vs the chained tail, fp32
BF16_SR_MIN_PSNR = 35.0  # bf16 keeps 8 significant bits: 2^-9 per rounding
TRUNK_F32_ATOL = 1e-4    # f32 trunk probs against a float64 run of it
INT8_SR_MIN_PSNR = 25.0  # interior int8 SR against the f32 SR, random weights
# bench.py's int8-SR rows (MODES): (sr_border_correction, clf_mode)
INT8_SR_ROWS = {"int8_sr_per_patch_int8": (True, "per_patch_int8"),
                "int8_sr_shared_trunk_int8": (True, "shared_trunk_int8"),
                "int8_sr_noborder_shared_trunk_int8": (False, "shared_trunk_int8")}
K4_SIZES = (128, 512, 1024, 2048)
CLASSIC_PAIRS, CLASSIC_HR, CLASSIC_LR = 16, 512, 128


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to deterministic algorithms while open, for checks that
    compare two training runs (as ``tools/serving_gate.py`` trains)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


@dataclass(frozen=True)
class Slice:
    """The served configuration: the shipped mode at its published widths."""
    lr: int = 128
    scale: int = 4
    blocks: int = 16
    filters: int = 64
    widths: tuple = (64, 128, 256, 512, 512)
    dense: int = 256
    patch: int = 96
    stride: int = 48
    batch: int = 16
    requests: int = 20
    frac: float = 0.25
    guard: float = 0.6
    bf16_frac: float = 0.28125

    @property
    def hr(self) -> int:
        return self.lr * self.scale

    def n_patches(self) -> int:
        from tpusr_torch.core.pad import pad_amounts
        from tpusr_torch.core.patches import patch_grid_size
        ph, pw = pad_amounts(self.hr, self.hr, self.patch, self.stride)
        nh, nw = patch_grid_size(self.hr + ph, self.hr + pw, self.patch,
                                 self.stride)
        return nh * nw

    def escalated(self) -> int:
        return max(1, min(self.batch, math.ceil(self.batch * self.frac - 1e-9)))


# ----------------------------------------------------------------- shapes

def vgg_conv_shapes(n: int, hw: int, widths, first_block: int = 1
                    ) -> list[tuple]:
    """(N, H, W, Cin, Cout) of the int8 VGG16 convs from block
    ``first_block`` on, for an (n, hw, hw) input to that block: pools after
    blocks 1-4 halve the grid."""
    from tpusr_torch.models.vgg import VGG16_CFG
    shapes = []
    cin = 3 if first_block == 1 else widths[first_block - 2]
    for (block, n_convs, _f), wd in zip(VGG16_CFG, widths):
        if block < first_block:
            continue
        for _ in range(n_convs):
            shapes.append((n, hw, hw, cin, wd))
            cin = wd
        if block < 5:
            hw //= 2
    return shapes


def k1_shapes(cfg: Slice) -> list[tuple[str, tuple, int]]:
    """(where, shape, launches per served batch) for K1: the shared trunk on
    the reflect-padded batch, then blocks 2-5 of the per-patch path on the
    escalated images' patches (block 1 is K3's)."""
    from tpusr_torch.core.pad import pad_amounts
    padded = cfg.hr + pad_amounts(cfg.hr, cfg.hr, cfg.patch, cfg.stride)[0]
    trunk = vgg_conv_shapes(cfg.batch, padded, cfg.widths)
    patches = vgg_conv_shapes(cfg.escalated() * cfg.n_patches(),
                              cfg.patch // 2, cfg.widths, first_block=2)
    return ([("trunk", s, 1) for s in trunk]
            + [("escalation", s, 1) for s in patches])


def k1_fallback_shapes(cfg: Slice) -> list[tuple]:
    """K1's shapes on a guard fallback: blocks 2-5 on every image's
    patches."""
    return vgg_conv_shapes(cfg.batch * cfg.n_patches(), cfg.patch // 2,
                           cfg.widths, first_block=2)


def n_per_patch_k1(cfg: Slice) -> int:
    """K1 launches of one per-patch call (blocks 2-5)."""
    return sum(1 for where, *_ in k1_shapes(cfg) if where == "escalation")


def reset_counts() -> None:
    from tpusr_torch.core import conv3x3, prng
    from tpusr_torch.models import block1
    conv3x3.reset_launch_counts()
    block1.reset_launch_counts()
    prng.reset_launch_counts()


def read_counts() -> dict:
    """The launch counts of every kernel on the serving and training paths
    (K5's draws as ``prng``)."""
    from tpusr_torch.core import conv3x3, prng
    from tpusr_torch.models import block1
    return {**conv3x3.LAUNCHES, **block1.LAUNCHES, **prng.LAUNCHES}


def k5_launches() -> int:
    from tpusr_torch.core import prng
    return prng.LAUNCHES["prng"]


# K5's launches by path: each phase that draws on the card adds its own
K5_BY_PATH: dict = {}

# the port's models, each built from a key by flax's draws (models/init.py)
MODEL_CLASSES = ("EDSR", "SRCNN", "VGG16Classifier", "VGG19Features",
                 "ESRGANGenerator", "ESRGANDiscriminator")
# K5's launches of every model built since ``watch_model_builds``
INIT_K5 = {"n": 0}


def watch_model_builds() -> None:
    """From here on, each build of a port model counts its K5 launches in
    ``INIT_K5`` and is held to the leaves it drew: on the card one launch a
    drawn leaf (``drawn_leaves``), on the CPU or with ``key=NO_DRAW`` none.
    A phase that builds a model inside a counted window expects these
    launches beside its own (``init_since``)."""
    import tpusr_torch.models as models
    from tpusr_torch.models.init import NO_DRAW, drawn_leaves

    for name in MODEL_CLASSES:
        cls = getattr(models, name)
        if getattr(cls.__init__, "watched", False):
            continue

        def init(self, *args, _orig=cls.__init__, _name=name, **kw):
            n0 = k5_launches()
            _orig(self, *args, **kw)
            got = k5_launches() - n0
            key = kw.get("key")
            drew = not (isinstance(key, str) and key == NO_DRAW)
            on_card = any(t.is_cuda for t in self.parameters())
            want = drawn_leaves(self) if drew and on_card else 0
            check(got == want, f"building {_name}: {got} K5 launches, not "
                               f"{want} (one a drawn leaf on the card)")
            INIT_K5["n"] += got
        init.watched = True
        cls.__init__ = init


def leaves_of(name: str, **kw) -> int:
    """The leaves a build of the port model ``name`` with ``kw`` draws,
    counted on a copy of zeros on the meta device (nothing drawn)."""
    import tpusr_torch.models as models
    from tpusr_torch.models.init import NO_DRAW, drawn_leaves
    return drawn_leaves(getattr(models, name)(**kw, device="meta",
                                              key=NO_DRAW))


def init_since(n0: int) -> int:
    """K5's launches of the model builds since ``INIT_K5["n"]`` was
    ``n0``."""
    return INIT_K5["n"] - n0


def in_path(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, the K5 launches of its model builds put in K5's
    ``launches_by_path`` as ``init_<name>``."""
    n0 = INIT_K5["n"]
    out = fn(*args, **kw)
    if init_since(n0):
        K5_BY_PATH[f"init_{name}"] = init_since(n0)
    return out


def launches_want(**counts) -> dict:
    """Expected launch counts: the given kernels, every other one 0."""
    return {**{k: 0 for k in read_counts()}, **counts}


def k2_shapes(cfg: Slice) -> list[tuple[str, tuple, bool, int]]:
    """(where, shape, relu, launches per served batch) for K2 in the x4
    fused SR forward: head, residual blocks and body conv on the LR grid,
    then up0/up1/tail on the 7-cell border-band slabs (top/bottom and
    left/right)."""
    n, h, f = cfg.batch, cfg.lr, cfg.filters
    out = [("head", (n, h, h, 3, f), False, 1),
           ("res.conv1", (n, h, h, f, f), True, cfg.blocks),
           ("res.conv2+body", (n, h, h, f, f), False, cfg.blocks + 1)]
    slab = 7                                  # 2 * pad + 1, pad = 3 at x4
    for name, rows, cols, cin, cout in (
            ("up0", slab, h, f, 4 * f), ("up1", 2 * slab, 2 * h, f, 4 * f),
            ("tail", 4 * slab, 4 * h, f, 3)):
        out.append((f"{name} top/bottom", (n, rows, cols, cin, cout), False, 2))
        out.append((f"{name} left/right", (n, cols, rows, cin, cout), False, 2))
    return out


def dequant_shapes(cfg: Slice) -> list[tuple[str, tuple, int]]:
    """(where, shape, launches per batch) of ``conv3x3_int8_dequant`` in the
    int8 SR forward: the head, and the residual-block and body convs."""
    n, h, f = cfg.batch, cfg.lr, cfg.filters
    return [("head", (n, h, h, 3, f), 1),
            ("res+body", (n, h, h, f, f), 2 * cfg.blocks + 1)]


def bound(ops: float, nbytes: float, kind: str,
          sfu_ops: float = 0.0) -> tuple[float, str]:
    """Least time in ms for ``ops`` operations of ``kind``, ``sfu_ops``
    special-function operations and ``nbytes`` of traffic."""
    t_ops = max(ops / PEAK_OPS_PER_S[kind], sfu_ops / PEAK_OPS_PER_S["sfu"]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_work(shape, elem_bytes: int, n_vecs: int = 2) -> tuple[float, float]:
    """Operations and bytes of one 3x3 conv launch: each input read once,
    each output written once, ``n_vecs`` f32 vectors per channel."""
    n, h, w, cin, cout = shape
    m = n * h * w
    ops = 2.0 * m * 9 * cin * cout
    nbytes = elem_bytes * (m * cin + 9 * cin * cout + m * cout) + 4 * n_vecs * cout
    return ops, nbytes


def nlm_work(h: int, w: int) -> tuple[float, float, float]:
    """fp32 operations, expf calls and bytes of the least work that K4's
    function needs on an (h, w) image. The weight of offset q at pixel p
    equals that of -q at p + q, bit for bit (the squared differences are
    equal and the box sums add the same positions in the same order), so
    each of the 84 offsets q that come before the centre serves both: its
    weights are needed on the image and on the image moved by -q. For each
    such q, over the union of those two regions: a difference and a square
    on the box-extended positions (2), the column sums (4 adds) on the
    weight rows by the box-extended columns, the row sums (4 adds), the 1/25
    scale, the subtraction of 2 sigma^2, the max and the scale by 1/h^2 (4)
    and one expf per weight. For each of the 168 offsets at each pixel: the
    multiply and add into num and the add into den (3); then one division
    per pixel. The image is read once, the output written once."""
    def union(a, b, dy, dx):     # an a x b region and its copy moved by q
        return 2 * a * b - max(a - abs(dy), 0) * max(b - abs(dx), 0)
    ops = exps = 0.0
    for k in range(84):
        dy, dx = k // 13 - 6, k % 13 - 6
        n_w = union(h, w, dy, dx)
        ops += (2 * union(h + 4, w + 4, dy, dx) + 4 * union(h, w + 4, dy, dx)
                + 8 * n_w)
        exps += n_w
    ops += 168 * 3 * h * w + h * w
    return ops, exps, 8.0 * h * w + 8.0


# ----------------------------------------------------------------- timing

def time_ms(fn, min_total_ms: float = 30.0, max_iters: int = 50) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around a run of
    launches after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    est = max(start.elapsed_time(end), 1e-3)
    iters = max(2, min(max_iters, int(min_total_ms / est)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def clocks_during(fn, seconds: float = 1.0) -> tuple[float, float]:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    every 100 ms while ``fn()`` runs back to back for ``seconds``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = [tuple(float(v) for v in line.split(",")[:2])
            for line in out.splitlines()[2:] if line.count(",") >= 1]
    if not rows:
        return float("nan"), float("nan")
    mhz, watts = zip(*rows)
    return float(np.median(mhz)), float(np.median(watts))


def host_ms(fn, sync) -> float:
    """Host-clock ms of ``fn()`` ended by a device barrier."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


# ----------------------------------------------------------------- phases

def phase_environment() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    from tpusr_torch.device import fp32_math
    fp32_math()
    print(card)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    return card


def phase_build() -> None:
    from tpusr_torch.core import _build
    t0 = time.perf_counter()
    names = _build.build_all()
    for name in names:
        _build.load(name)
    print(f"[build] {', '.join(f'csrc/{n}.cu' for n in names)} built and "
          f"loaded in {time.perf_counter() - t0:.2f} s")


PRNG_NORMAL_ULP = 0      # K5's normals against the plain version's, in ulp
# The SASS opcodes of K5's loop by the pipe that runs them: 32-bit integer
# on the ALU pipe (64 lanes an SM), IMAD and fp32 on the FMA pipes (128)
SASS_ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP",
            "LEA", "IMNMX", "PRMT", "SEL", "IABS", "VIADD", "FSETP", "FSEL",
            "FMNMX"}
SASS_FMA = {"IMAD", "IMUL", "FADD", "FMUL", "FFMA"}


@dataclass(frozen=True)
class PrngSlice:
    """K5 (``csrc/prng.cu``) on the card against the plain version on the
    card and the CPU's draw: the keys and the shapes the port draws at (a
    scalar, the gate's (n,) parameters and its crop offsets, the surfaces'
    background cells, a VGG16 kernel's truncated normal), the gate's surface
    noise, the two-round permutation of 5000 and a batch's indices."""
    seeds: tuple = (0, 7, 42)
    shapes: tuple = ((), (128,), (128, 17, 17, 1), (3, 3, 512, 512))
    noise: tuple = (128, 512, 512, 3)
    kernel: tuple = (3, 3, 512, 512)
    batch: int = 64
    pool: int = 2048
    perm: int = 5000


def k5_loop_instructions(kind: int) -> dict:
    """The SASS of K5's loop for the sampler ``kind`` (``prng._KINDS``,
    drawn from counters): the instructions from the address the widest
    backward branch returns to through that branch (one value a trip: the
    loop is not unrolled), counted by pipe (``SASS_ALU``, ``SASS_FMA``)
    and in all."""
    import re
    from tpusr_torch.core import _build
    sass = _build.sass("prng")
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs
                 if re.match(rf"\S*prng_kernelILi{kind}ELb0E", f)), None)
    check(body is not None, f"[prng] no prng_kernel<{kind}, false> in the SASS")
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)(?:\.\S+)?\s*([^;]*)")
    code = [(int(m.group(1), 16), m.group(2), m.group(3))
            for ln in body.splitlines() if (m := insn.search(ln))]
    loops = [(at - int(t.group(1), 16), int(t.group(1), 16), at)
             for at, op, args in code
             if op == "BRA" and (t := re.match(r"`?\(?0x([0-9a-f]+)", args))
             and int(t.group(1), 16) < at]
    check(bool(loops), f"[prng] no loop in prng_kernel<{kind}>'s SASS")
    _, lo, hi = max(loops)
    ops = [op for at, op, _ in code if lo <= at <= hi]
    return {"alu": sum(o in SASS_ALU for o in ops),
            "fma": sum(o in SASS_FMA for o in ops), "all": len(ops)}


def phase_prng(p: PrngSlice, dev, card: str) -> dict:
    """``phase_prng``: K5 against the plain version on the card and the
    CPU's draw for every sampler, seed and shape; the normal samplers over
    all 2^23 mantissas; the 100.7 M threefry words and normals of the
    gate's noise; K5's ms beside the plain version's and ``torch.randn``'s;
    its bound from the SASS of its loop."""
    from tpusr_torch.core import prng

    cpu = torch.device("cpu")
    samplers = {
        "bits": lambda f, k, sh, d: f(k, sh, device=d),
        "uniform": lambda f, k, sh, d: f(k, sh, 0.3, 0.7, device=d),
        "randint": lambda f, k, sh, d: f(k, sh, 0, 2048, device=d),
        "bernoulli": lambda f, k, sh, d: f(k, 0.8, sh, device=d),
        "normal": lambda f, k, sh, d: f(k, sh, device=d),
        "normal_erf_inv": lambda f, k, sh, d: f(k, sh, device=d),
        "truncated_normal": lambda f, k, sh, d: f(k, -2.0, 2.0, sh,
                                                  device=d)}

    def ulps(a, b):
        return int((a.view(torch.int32).long()
                    - b.view(torch.int32).long()).abs().max()) if a.numel() else 0

    def agree(got, plain, want, what):
        check(got.dtype == plain.dtype == want.dtype
              and got.shape == plain.shape == want.shape,
              f"[prng] {what}: {got.dtype} {tuple(got.shape)}, plain "
              f"{plain.dtype} {tuple(plain.shape)}, CPU {want.dtype}")
        if got.is_floating_point():
            worst = max(ulps(got, plain), ulps(got.cpu(), want))
            check(worst <= PRNG_NORMAL_ULP, f"[prng] {what}: {worst} ulp from "
                                            f"the plain version")
        check(torch.equal(got, plain) and torch.equal(got.cpu(), want),
              f"[prng] {what}: K5 differs from the plain version")

    reset_counts()
    n_draws = launched = 0
    for seed in p.seeds:
        key = prng.PRNGKey(seed)
        for shape in p.shapes:
            for name, draw in samplers.items():
                agree(draw(getattr(prng, name), key, shape, dev),
                      draw(prng.PLAIN[name], key, shape, dev),
                      draw(getattr(prng, name), key, shape, cpu),
                      f"{name} seed {seed} {shape}")
                n_draws += 1
                launched += 1 if math.prod(shape) else 0
    key6 = prng.PRNGKey(6)
    agree(prng.permutation(key6, p.perm, dev),
          prng.permutation_plain(key6, p.perm, dev),
          prng.permutation(key6, p.perm, cpu), f"permutation of {p.perm}")
    launched += 2                                # its two sort rounds
    got = read_counts()["prng"]
    check(got == launched, f"[prng] {got} K5 launches for {launched} draws")

    # every mantissa through both normal samplers: K5 on words, the plain
    # version on the card and the CPU's table
    words = torch.arange(prng._MANTISSAS, dtype=torch.int32, device=dev) << 9
    for bounds in ((None, None), (-2.0, 2.0)):
        plain = prng._normal_values(words, *bounds)
        table = prng._normal_table(*bounds, cpu)
        if bounds[0] is None:
            plain, table = plain * prng.SQRT2, table * prng.SQRT2
        agree(prng.normal_from_words(words, *bounds), plain, table,
              f"the 2^23 mantissas at bounds {bounds}")
    del words, plain

    # the gate's noise: all its threefry words, then its normals
    key = prng.split(prng.PRNGKey(p.seeds[0]), 9)[5]   # the gate's ks[5]
    n = math.prod(p.noise)
    check(torch.equal(prng.bits(key, p.noise, dev),
                      prng.bits_plain(key, p.noise, dev)),
          f"[prng] the gate's noise: K5's {n} words differ from the plain "
          f"version's")
    noise = prng.normal(key, p.noise, dev)
    plain = prng.normal_plain(key, p.noise, dev)
    check(torch.equal(noise, plain), "[prng] the gate's noise: K5's normals "
                                     "differ from the plain version's")
    err = float((noise - plain).abs().max())
    check(bool(torch.isfinite(noise).all()), "[prng] non-finite noise")
    del noise, plain
    torch.cuda.empty_cache()

    draws = {
        "gate_noise_normal": (
            lambda: prng.normal(key, p.noise, dev),
            lambda: prng.normal_plain(key, p.noise, dev),
            lambda: torch.randn(p.noise, device=dev)),
        "vgg_kernel_truncated_normal": (
            lambda: prng.truncated_normal(key, -2.0, 2.0, p.kernel, dev),
            lambda: prng.truncated_normal_plain(key, -2.0, 2.0, p.kernel, dev),
            lambda: torch.randn(p.kernel, device=dev)),
        "batch_randint": (
            lambda: prng.randint(key, (p.batch,), 0, p.pool, dev),
            lambda: prng.randint_plain(key, (p.batch,), 0, p.pool, dev),
            lambda: torch.randint(0, p.pool, (p.batch,), device=dev))}
    ms = {name: {"ms": time_ms(k5), "plain_ms": time_ms(plain, max_iters=5),
                 "randn_ms": time_ms(yard)}
          for name, (k5, plain, yard) in draws.items()}
    torch.cuda.empty_cache()

    sass = {name: k5_loop_instructions(prng._KINDS[name][0])
            for name in ("bits32", "normal")}
    # the least time of the gate's noise: the loop of the normal sampler
    # that is timed (threefry, then erf_inv over log1p), by the ALU pipe,
    # the FMA pipes and the issue of 4 warp instructions a clock an SM;
    # threefry's loop alone (``bits32``) is printed beside it
    def loop_ms(c):
        return max(c["alu"] / PEAK_OPS_PER_S["int32"],
                   c["fma"] / (2 * PEAK_OPS_PER_S["int32"]),
                   c["all"] / (2 * PEAK_OPS_PER_S["int32"])) * n * 1e3
    bits, normal = sass["bits32"], sass["normal"]
    t_ops, t_hash = loop_ms(normal), loop_ms(bits)
    t_bytes = 4.0 * n / HBM_BYTES_PER_S * 1e3
    print(f"[prng] {n_draws + 1} draws by K5 on the card (7 samplers x seeds "
          f"{list(p.seeds)} x shapes {[list(s) for s in p.shapes]}, "
          f"permutation({p.perm})) equal to the plain version on the card and "
          f"to the CPU's draw, bit for bit, in {launched} launches; both "
          f"normal samplers equal over all 2^23 mantissas (K5 on words, the "
          f"plain version on the card, the CPU's tables); the gate's noise "
          f"{list(p.noise)}: all {n} threefry words and normals equal "
          f"(max |err| {err})")
    print(f"[prng] {card}: ms on the card (CUDA events): "
          + "; ".join(f"{k} K5 {v['ms']:.4f}, plain {v['plain_ms']:.3f} "
                      f"(torch.randn/randint at the shape, another function: "
                      f"{v['randn_ms']:.4f})" for k, v in ms.items()))
    print(f"[prng] K5's loop in SASS, instructions a value by pipe: bits "
          f"{bits}, normal {normal}; the gate's noise ({n} values): the "
          f"normal loop {t_ops:.4f} ms ({normal['all']} instructions a value "
          f"issued at {2 * PEAK_OPS_PER_S['int32'] / 1e12:.2f} T/s, "
          f"{normal['alu']} on the ALU pipe at "
          f"{PEAK_OPS_PER_S['int32'] / 1e12:.2f} T/s), threefry alone "
          f"{t_hash:.4f} ms, against {t_bytes:.4f} ms for its "
          f"{4 * n / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    g = ms["gate_noise_normal"]
    return {"err": err, "ms": g["ms"], "plain_ms": g["plain_ms"],
            "randn_ms": g["randn_ms"], "bound_ms": max(t_ops, t_bytes),
            "t_ops": t_ops, "t_bytes": t_bytes, "threefry_ms": t_hash,
            "by_draw": ms, "sass": sass,
            "phase_launches": launched}


@dataclass(frozen=True)
class InitSlice:
    """The port's models built at full width on the card, each leaf drawn
    by K5 (``models/init.py``), against the parent's way: drawn on the CPU,
    then moved."""
    repeats: int = 3             # builds a way and a model; the best is kept


# the serving gate's two models, built first in a fresh process
GATE_MODELS = ("VGG16", "EDSR x4")


def init_models(seed: int) -> dict:
    """name -> build(device) of the seven full-width models of
    ``phase_init``, from keys of ``seed``; the gate's two first."""
    from tpusr_torch.config import ESRGANConfig
    from tpusr_torch.models import (EDSR, SRCNN, ESRGANDiscriminator,
                                    ESRGANGenerator)
    from tpusr_torch.models.vgg import VGG16Classifier, VGG19Features

    c8 = ESRGANConfig()

    def key(k):
        return seed * 100 + 90 + k
    return {
        "VGG16": lambda d: VGG16Classifier(num_classes=2, dense_units=256,
                                           device=d, key=key(1)),
        "EDSR x4": lambda d: EDSR(scale_factor=4, device=d, key=key(2)),
        "SRCNN": lambda d: SRCNN(device=d, key=key(3)),
        "VGG19 to block5_conv4": lambda d: VGG19Features(device=d,
                                                         key=key(4)),
        "ESRGAN g32x23": lambda d: ESRGANGenerator(device=d, key=key(5)),
        f"ESRGAN g{c8.growth_channels}x{c8.num_rrdb_blocks}": lambda d:
            ESRGANGenerator(c8.scale_factor, c8.growth_channels,
                            c8.num_rrdb_blocks, device=d, key=key(6)),
        "discriminator": lambda d: ESRGANDiscriminator(device=d, key=key(7)),
    }


def model_leaves(m) -> dict:
    return {**dict(m.named_parameters()), **dict(m.named_buffers())}


def init_probe(mode: str, seed: int, dev) -> dict:
    """In a fresh process: build the gate's two models (``mode`` "card")
    or the seven on the card, or the gate's two the parent's way (``mode``
    "cpu": drawn on the CPU, then moved), timed on the host clock, and
    record what the host drew: the CPU's normal tables, the plain draws'
    words on the CPU (``prng._bits32``), torch's CPU generator."""
    from tpusr_torch.core import prng
    from tpusr_torch.models.init import drawn_leaves

    words = []
    plain = prng._bits32

    def recorded(key, shape, device):
        words.append(str(torch.device(device or "cpu")))
        return plain(key, shape, device)
    prng._bits32 = recorded
    rng_state = torch.random.get_rng_state()
    models = init_models(seed)
    out = {"mode": mode}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mode == "cpu":
        built = {n: models[n]("cpu").to(dev) for n in GATE_MODELS}
    else:
        reset_counts()
        built = {n: models[n](dev) for n in GATE_MODELS}
    torch.cuda.synchronize()
    out["gate_ms"] = (time.perf_counter() - t0) * 1e3
    if mode == "card":
        built.update({n: b(dev) for n, b in models.items()
                      if n not in GATE_MODELS})
        torch.cuda.synchronize()
        out["all_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = read_counts()
        out["drawn"] = sum(drawn_leaves(m) for m in built.values())
        out["on_card"] = all(t.is_cuda for m in built.values()
                             for t in model_leaves(m).values())
    out["cpu_tables"] = [list(k) for k in prng._TABLES if k[0] == "cpu"]
    out["cpu_draws"] = sum(w == "cpu" for w in words)
    out["card_plain_draws"] = sum(w != "cpu" for w in words)
    out["cpu_generator_moved"] = not torch.equal(rng_state,
                                                 torch.random.get_rng_state())
    return out


def run_init_probe(mode: str, seed: int) -> dict:
    """``init_probe(mode)`` in a fresh process of this script."""
    done = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--init-probe", mode, "--seed", str(seed)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    check(done.returncode == 0, f"[init] the {mode} probe exited "
          f"{done.returncode}: {done.stderr[-2000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def phase_init(s: InitSlice, dev, seed: int, card: str) -> dict:
    """Each of the seven models built on the card (its leaves by K5, one
    launch a drawn leaf and no other kernel) and the parent's way, drawn on
    the CPU and moved: host ms of each, best of ``s.repeats``; every leaf
    torch.equal between the two. Then a fresh process that builds all seven
    on the card, which must build no CPU table and draw nothing on the
    host, and one that builds the gate's two the parent's way."""
    from tpusr_torch.models.init import drawn_leaves

    sync = torch.cuda.synchronize
    rows, launched = {}, 0
    for name, build in init_models(seed).items():
        card_ms, host_ms_ = [], []
        for _ in range(s.repeats):
            sync()
            reset_counts()
            t0 = time.perf_counter()
            m = build(dev)
            sync()
            card_ms.append((time.perf_counter() - t0) * 1e3)
            got, drawn = read_counts(), drawn_leaves(m)
            check(got == launches_want(prng=drawn), f"[init] {name} on the "
                  f"card launched {got}, not {drawn} K5 launches (its drawn "
                  f"leaves) and no other kernel")
            launched += got["prng"]
            check(all(t.device == dev for t in model_leaves(m).values()),
                  f"[init] {name}: a leaf is not on {dev}")
        for _ in range(s.repeats):
            sync()
            t0 = time.perf_counter()
            h = build("cpu").to(dev)
            sync()
            host_ms_.append((time.perf_counter() - t0) * 1e3)
        a, b = model_leaves(m), model_leaves(h)
        check(list(a) == list(b), f"[init] {name}: leaves {list(a)} != "
                                  f"{list(b)}")
        apart = sum(int((a[k] != b[k]).sum()) for k in a)
        check(apart == 0 and all(torch.equal(a[k], b[k]) for k in a),
              f"[init] {name}: {apart} values differ between the card's "
              f"build and the CPU's")
        n_values = sum(t.numel() for t in a.values())
        rows[name] = {"card_ms": min(card_ms), "card_first_ms": card_ms[0],
                      "cpu_ms": min(host_ms_), "cpu_first_ms": host_ms_[0],
                      "launches": drawn, "leaves": len(a),
                      "values": n_values}
        print(f"[init] {card}: {name}: {len(a)} leaves, {n_values} values, "
              f"{drawn} drawn: built on the card in {min(card_ms):.2f} ms "
              f"(host clock, synchronised, best of {s.repeats}; first "
              f"{card_ms[0]:.2f}) with {drawn} K5 launches, against "
              f"{min(host_ms_):.2f} ms drawn on the CPU and moved (first "
              f"{host_ms_[0]:.2f}); every leaf torch.equal, 0 values apart")
        del m, h, a, b
    K5_BY_PATH["init"] = launched
    torch.cuda.empty_cache()

    probe = run_init_probe("card", seed)
    want = launches_want(prng=probe["drawn"])
    check(probe["launches"] == want and probe["on_card"],
          f"[init] the fresh process launched {probe['launches']}, not "
          f"{want}, or left a leaf off the card")
    check(not probe["cpu_tables"] and probe["cpu_draws"] == 0
          and probe["card_plain_draws"] == 0
          and not probe["cpu_generator_moved"],
          f"[init] the fresh process drew on the host: CPU tables "
          f"{probe['cpu_tables']}, {probe['cpu_draws']} plain CPU draws, "
          f"{probe['card_plain_draws']} plain draws on the card, torch's "
          f"CPU generator moved {probe['cpu_generator_moved']}")
    parent = run_init_probe("cpu", seed)
    print(f"[init] {card}: a fresh process builds the seven on the card in "
          f"{probe['all_ms']:.1f} ms ({probe['drawn']} K5 launches), the "
          f"gate's two ({', '.join(GATE_MODELS)}) in "
          f"{probe['gate_ms']:.1f} ms, with no CPU table, no plain draw and "
          f"torch's CPU generator unmoved; the gate's two the parent's way "
          f"(drawn on the CPU, moved) {parent['gate_ms']:.1f} ms, building "
          f"CPU tables {parent['cpu_tables']} and {parent['cpu_draws']} "
          f"plain CPU draws")
    return {"rows": rows, "probe": probe, "parent_probe": parent}


def _int8_operands(shape, g, dev):
    n, h, w, cin, cout = shape
    x = torch.randint(-127, 128, (n, h, w, cin), generator=g, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, device=dev,
                       dtype=torch.int8)
    # |acc| ~ sqrt(9 cin) * 127^2 / 3: rescale spreads outputs over the clip
    # range, so both clips and the interior are exercised
    acc_std = math.sqrt(9 * cin) * 127.0 ** 2 / 3.0
    rs = (torch.rand(cout, generator=g, device=dev) + 0.5) * (40.0 / acc_std)
    b = torch.rand(cout, generator=g, device=dev) * 20.0 - 10.0 + 0.5
    return x, wq, rs, b


def block1_operands(g, dev, n: int, h: int, w: int, packed: bool = True):
    """A block-1 int8 tree (b1c1 3 -> 64, b1c2 64 -> 64) with K1's spread of
    rescales and biases (and K1's packed copies of the kernels, as the int8
    trees carry them, unless not ``packed``), and (n, h, w, 3) int8
    images."""
    from tpusr_torch.core.conv3x3 import pack_int8_kernel
    q = {"layers": {}}
    for name, cin in (("block1_conv1", 3), ("block1_conv2", 64)):
        _, wq, rs, b = _int8_operands((1, 1, 1, cin, 64), g, dev)
        q["layers"][name] = {"kernel_q": wq, "rescale": rs, "bias_over_out": b}
        if packed:
            q["layers"][name]["kernel_packed"] = pack_int8_kernel(wq)
    images = torch.randint(-127, 128, (n, h, w, 3), generator=g, device=dev,
                           dtype=torch.int8)
    return q, images


def int_mm_yardstick(x, wq, rs, b, y, dequant: bool):
    """Device ms of ``torch._int_mm`` on a prebuilt im2col of ``x`` (the
    GEMM alone: not the same function, a yardstick for the kernel's GEMM),
    or None where _int_mm does not take the shape (K or Cout not a multiple
    of 8). Its int32 sums, requantized (or dequantized) as the twin does,
    must equal the kernel's output ``y``."""
    from tpusr_torch.models.edsr_quant import im2col
    cin, cout = wq.shape[2], wq.shape[3]
    if (9 * cin) % 8 or cout % 8:
        return None
    cols, wmat = im2col(x, 3), wq.reshape(9 * cin, cout)
    acc = torch._int_mm(cols, wmat).reshape(*y.shape).float() * rs + b
    same = (torch.equal(acc.to(torch.bfloat16).view(torch.int16),
                        y.view(torch.int16)) if dequant else
            torch.equal(acc.clamp(0.0, 127.0).to(torch.int8), y))
    check(same, f"torch._int_mm on the im2col differs from the kernel at "
                f"{tuple(x.shape)} -> {cout}")
    del acc
    ms = time_ms(lambda: torch._int_mm(cols, wmat), max_iters=20)
    del cols
    return ms


def phase_k1(cfg: Slice, dev) -> dict:
    """K1 against its twin at the served shapes (the record: one batch
    without the guard fallback) and at the guard fallback's shapes (their
    own total line)."""
    from tpusr_torch.core.conv3x3 import (conv3x3_int8_requant,
                                          conv3x3_int8_requant_plain,
                                          pack_int8_kernel)
    g = torch.Generator(device=dev).manual_seed(1)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0,
           "t_ops": 0.0, "t_bytes": 0.0, "gemm_library_ms": 0.0}
    fb = {"ms": 0.0, "bound_ms": 0.0, "gemm_library_ms": 0.0}
    shapes = k1_shapes(cfg) + [("fallback", s, 1)
                               for s in k1_fallback_shapes(cfg)]
    deepest = 12                          # trunk block 5, its last conv
    n_gemm = {"served": 0, "fallback": 0}
    for i, (where, shape, mult) in enumerate(shapes):
        served = where != "fallback"
        x, wq, rs, b = _int8_operands(shape, g, dev)
        wp = pack_int8_kernel(wq)
        y = conv3x3_int8_requant(x, wq, rs, b, wp)
        yp = conv3x3_int8_requant_plain(x, wq, rs, b)
        torch.cuda.synchronize()
        err = int((y.int() - yp.int()).abs().max())
        check(torch.equal(y, yp), f"K1 differs from its twin at {shape}: "
                                  f"{int((y != yp).sum())} values, max {err}")
        spread = int(torch.unique(y).numel())
        del yp
        ms = time_ms(lambda: conv3x3_int8_requant(x, wq, rs, b, wp))
        pms = (time_ms(lambda: conv3x3_int8_requant_plain(x, wq, rs, b),
                       min_total_ms=10.0, max_iters=5) if served else None)
        lms = int_mm_yardstick(x, wq, rs, b, y, dequant=False)
        ops, nbytes = conv_work(shape, 1)
        bms, by = bound(ops, nbytes, "int8")
        extra = ""
        if i == deepest:
            mhz, watts = clocks_during(
                lambda: conv3x3_int8_requant(x, wq, rs, b, wp))
            extra = f"  under load SM clock {mhz:.0f} MHz, {watts:.0f} W (median)"
        print(f"[K1] {where:10s} {str(shape):28s} equal (max|err| {err}, "
              f"{spread} levels)  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} "
              f"TOP/s, {100 * bms / ms:.1f}% of bound)  twin "
              + (f"{pms:.4f} ms" if served else "not timed")
              + "  _int_mm GEMM " + (f"{lms:.4f} ms" if lms else "n/a (K % 8)")
              + f"  bound {bms:.4f} ms ({by})  x{mult}/batch{extra}")
        acc = tot if served else fb
        acc["ms"] += mult * ms
        acc["bound_ms"] += mult * bms
        if lms is not None:
            acc["gemm_library_ms"] += mult * lms
            n_gemm["served" if served else "fallback"] += 1
        if served:
            tot["plain_ms"] += mult * pms
            tot["t_" + ("ops" if by == "operations" else by)] += mult * bms
        tot["err"] = max(tot["err"], err)
        del x, wq, wp, y
    torch.cuda.empty_cache()
    n_served = len(k1_shapes(cfg))
    print(f"[K1] per served batch of {cfg.batch} (no fallback): kernel "
          f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f}%), _int_mm GEMM "
          f"{tot['gemm_library_ms']:.3f} ms over {n_gemm['served']} of "
          f"{n_served} shapes")
    print(f"[K1] guard fallback ({cfg.batch * cfg.n_patches()} patches, "
          f"{len(k1_fallback_shapes(cfg))} shapes, all bit-equal): kernel "
          f"{fb['ms']:.3f} ms, bound {fb['bound_ms']:.3f} ms "
          f"({100 * fb['bound_ms'] / fb['ms']:.1f}%), _int_mm GEMM "
          f"{fb['gemm_library_ms']:.3f} ms over {n_gemm['fallback']} shapes")
    return tot


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps, across zero (bit patterns on a monotone line)."""
    def line(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(a) - line(b)).abs()


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |v| (8 significant bits), float32."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def k2_bf16_tolerance(x: torch.Tensor, k: torch.Tensor, y: torch.Tensor,
                      yp: torch.Tensor) -> torch.Tensor:
    """The largest |y - yp| (float64, per output) that two bf16 results of
    one K2-bf16 conv on bf16 ``x`` (N, H, W, Cin) and ``k`` (3, 3, Cin, Cout)
    may differ by when each sums the exact bf16 products in fp32 in its own
    order, adds the same bias, takes the same ReLU and rounds once to bf16:

        1 bf16 ulp(max(|y|, |yp|)) + 2 * 9*Cin * 2^-23 * S,  S = conv(|x|, |w|)

    The first term is the two roundings at the store (half an ulp each).
    The second is the classical bound on an fp32 sum of K = 9*Cin terms in
    any order, (K - 1) * 2^-24 * sum|terms|, doubled because tensor cores may
    truncate where they align, and taken for both sides. S, the sum of the
    products' magnitudes, comes from the twin on |x|, |w| in float64. The
    bias add and ReLU move the two sides by no more than that. A value
    beyond it is a fault, not a reason to widen it."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain
    zero = torch.zeros(k.shape[-1], dtype=torch.float64, device=x.device)
    s = conv3x3_bias_act_plain(x.double().abs(), k.double().abs(), zero)
    ulp = bf16_ulp(torch.maximum(y.float().abs(), yp.float().abs())).double()
    return K2_BF16_ULPS * ulp + 2 * 9 * x.shape[-1] * FP32_SUM_UNIT * s


def check_k2_bf16(x, k, y, yp) -> tuple[int, int, float]:
    """Hold K2-bf16's output ``y`` to its twin's ``yp`` on bf16 ``x``, ``k``
    by ``k2_bf16_tolerance``; raises ``CheckFailed`` beyond it. Returns the
    largest ulp distance, the count of outputs more than one ulp apart and
    the largest |y - yp|."""
    d = (y.double() - yp.double()).abs()
    tol = k2_bf16_tolerance(x, k, y, yp)
    ulps = _bf16_ulps(y, yp)
    n_out = int((d > tol).sum())
    check(n_out == 0, f"K2-bf16 vs its twin at {tuple(x.shape)}->"
                      f"{tuple(y.shape)}: {n_out} values beyond 1 ulp + "
                      f"2 K 2^-23 sum|x||w| (max ulp distance "
                      f"{int(ulps.max())})")
    return int(ulps.max()), int((ulps > K2_BF16_ULPS).sum()), float(d.max())


def block1_work(n: int, h: int, w: int, patch: int, n_patches: int
                ) -> tuple[float, float]:
    """int8 operations and bytes of one K3 launch: both convs' MACs on every
    patch pixel (27 and 576 per output channel), the images read once, the
    weights and the four per-channel vectors read once, the pooled output
    written once."""
    ops = 2.0 * n_patches * patch * patch * 64 * (27 + 576)
    nbytes = (n * h * w * 3 + 9 * 64 * (3 + 64) + 4 * 4 * 64
              + n_patches * (patch // 2) ** 2 * 64)
    return ops, float(nbytes)


# SASS mnemonics: int8 wgmma, int8 mma.sync, dp4a
SASS_OPS = {"wgmma": "IGMMA", "mma.sync": "IMMA", "dp4a": "IDP"}


def build_log_lines(name: str) -> list[str]:
    """The lines nvcc printed when it built the library that is loaded for
    ``csrc/<name>.cu``; fails when that build's log is missing."""
    from tpusr_torch.core import _build
    log = _build.build_log(name)
    check(log.exists(), f"{name}.cu: no build log {log.name} beside its library")
    return log.read_text().splitlines()


def k3_instructions() -> dict:
    """Count of each of ``SASS_OPS`` in K3's SASS; fails unless its products
    run on the int8 tensor cores with no dp4a left. Prints any ptxas
    warning about its wgmma (serialised products) from the build log."""
    import re
    from tpusr_torch.core import _build
    sass = _build.sass("block1")
    counts = {k: len(re.findall(rf"\b{op}\b", sass))
              for k, op in SASS_OPS.items()}
    warns = [ln.strip() for ln in build_log_lines("block1")
             if "wgmma" in ln.lower() and "warning" in ln.lower()]
    print(f"[K3] instructions in the SASS of csrc/block1.cu: {counts}; ptxas "
          f"wgmma warnings: {warns or 'none'}")
    check(counts["wgmma"] + counts["mma.sync"] > 0 and counts["dp4a"] == 0,
          f"K3 is not on the int8 tensor cores: {counts}")
    return counts


def phase_k3(cfg: Slice, dev) -> dict:
    """K3 against its plain twin at the per-patch path's shapes; the path it
    replaced (patch extraction, two K1 launches, the pool) held equal and
    timed beside it. Returns the record of the escalation's shape, the
    served batch's K3 launch on the path without the guard fallback."""
    from tpusr_torch.core.conv3x3 import conv3x3_int8_requant
    from tpusr_torch.models.block1 import (block1_int8, block1_plain,
                                           extract_patches_reference,
                                           grid_counts, max_pool2x2)
    counts = k3_instructions()
    instruction = "wgmma" if counts["wgmma"] else "mma.sync"
    g = torch.Generator(device=dev).manual_seed(5)
    rec = {}
    for where, n, hw in (("escalation", cfg.escalated(), cfg.hr),
                         ("guard fallback", cfg.batch, cfg.hr),
                         ("one 128^2 image", 1, 128)):
        q, images = block1_operands(g, dev, n, hw, hw)
        l1, l2 = (q["layers"][k] for k in ("block1_conv1", "block1_conv2"))

        def plain():   # 4 images at a time: float64 activations are large
            return torch.cat([block1_plain(q, images[i:i + 4], cfg.patch,
                                           cfg.stride)
                              for i in range(0, n, 4)])

        def k1_block1():
            x = extract_patches_reference(images, cfg.patch, cfg.stride)
            for layer in (l1, l2):
                x = conv3x3_int8_requant(x, layer["kernel_q"], layer["rescale"],
                                         layer["bias_over_out"],
                                         layer["kernel_packed"])
            return max_pool2x2(x)

        y = block1_int8(q, images, cfg.patch, cfg.stride)
        yp = plain()
        torch.cuda.synchronize()
        n_diff = int((y != yp).sum())
        check(y.shape == yp.shape and n_diff == 0,
              f"K3 differs from its twin at {where}: {n_diff} values")
        check(torch.equal(k1_block1(), y), f"K3 != patches + 2 K1 + pool at "
                                           f"{where}")
        spread = int(torch.unique(y).numel())
        ms = time_ms(lambda: block1_int8(q, images, cfg.patch, cfg.stride))
        pms = time_ms(plain, min_total_ms=10.0, max_iters=3)
        k1ms = time_ms(k1_block1, max_iters=10)
        n_h, n_w = grid_counts(hw, hw, cfg.patch, cfg.stride)
        ops, nbytes = block1_work(n, hw, hw, cfg.patch, n * n_h * n_w)
        bms, by = bound(ops, nbytes, "int8")
        print(f"[K3] {where:16s} {n} x {hw}^2 -> {tuple(y.shape)}: 0 of "
              f"{y.numel()} int8 values differ ({spread} levels), equal to "
              f"patches + 2 K1 + pool  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f}"
              f" TOP/s, {100 * bms / ms:.1f}% of bound, {instruction})  twin "
              f"{pms:.4f} ms  bound {bms:.4f} ms ({by}: {ops / 1e9:.1f} G int8"
              f" ops)  patches + 2 K1 + pool {k1ms:.4f} ms "
              f"({k1ms / ms:.2f}x the kernel's time)")
        if where == "escalation":
            rec = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "err": 0.0,
                   "t_ops": bms if by == "operations" else 0.0,
                   "t_bytes": bms if by == "bytes" else 0.0,
                   "k1_path_ms": k1ms, "instruction": instruction}
        del q, images, y, yp
    torch.cuda.empty_cache()
    return rec


def phase_k2(cfg: Slice, dev, dtype: torch.dtype) -> dict:
    """K2 in ``dtype`` (float32 or bfloat16) against its plain twin at every
    shape of the SR forward, timed beside the twin and ``F.conv2d`` in the
    same dtype; the body conv's images 0-1 against a 2-image launch."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
    bf16 = dtype == torch.bfloat16
    tag, elem, kind = ("K2-bf16", 2, "bf16") if bf16 else ("K2", 4, "fp32")
    g = torch.Generator(device=dev).manual_seed(3 if bf16 else 2)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "err": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
    for where, shape, relu, mult in k2_shapes(cfg):
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), generator=g, device=dev).to(dtype)
        k = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
             * math.sqrt(2.0 / (9 * cin))).to(dtype)
        b = torch.randn(cout, generator=g, device=dev) * 0.1
        y = conv3x3_bias_act(x, k, b, relu)
        yp = conv3x3_bias_act_plain(x, k, b, relu)
        torch.cuda.synchronize()
        check(y.dtype == dtype, f"{tag} returned {y.dtype}")
        if bf16:
            ulps, n_over, err = check_k2_bf16(x, k, y, yp)
            agree = (f"vs twin max {ulps} ulp, {n_over} of {y.numel()} beyond "
                     f"1 ulp, all within the derived bound (max|err| "
                     f"{err:.3g})")
        else:
            err = float((y - yp).abs().max())
            check(err <= K2_ATOL, f"K2 differs from its twin at {shape}: "
                                  f"max|err| {err} > {K2_ATOL}")
            agree = f"max|err| {err:.3g}"
        if where == "res.conv1":        # batch invariance at the body shape
            same = torch.equal(y[:2], conv3x3_bias_act(x[:2], k, b, relu))
            check(same, f"{tag}: images 0-1 of a {n}-image launch differ from "
                        f"a 2-image launch at {shape}")
            mhz, watts = clocks_during(lambda: conv3x3_bias_act(x, k, b, relu))
            agree += (f"; images 0-1 == a 2-image launch; under load SM clock "
                      f"{mhz:.0f} MHz, {watts:.0f} W (median)")
        x_nchw, k_oihw = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous()
        b_lib = b.to(dtype)
        ms = time_ms(lambda: conv3x3_bias_act(x, k, b, relu))
        pms = time_ms(lambda: conv3x3_bias_act_plain(x, k, b, relu))
        lms = time_ms(lambda: F.conv2d(x_nchw, k_oihw, b_lib, padding=1))
        ops, nbytes = conv_work(shape, elem, n_vecs=1)
        bms, by = bound(ops, nbytes, kind)
        print(f"[{tag}] {where:20s} {str(shape):27s} relu={int(relu)} {agree}"
              f"  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * bms / ms:.1f}% of bound)  twin {pms:.4f} ms  F.conv2d "
              f"{kind} {lms:.4f} ms  bound {bms:.4f} ms ({by})  x{mult}/batch")
        tot["ms"] += mult * ms
        tot["plain_ms"] += mult * pms
        tot["library_ms"] += mult * lms
        tot["bound_ms"] += mult * bms
        tot["t_" + ("ops" if by == "operations" else by)] += mult * bms
        tot["err"] = max(tot["err"], err)
        del x, k, y, yp
    torch.cuda.empty_cache()
    print(f"[{tag}] per batch of {cfg.batch}: kernel {tot['ms']:.3f} ms, "
          f"F.conv2d {kind} {tot['library_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.3f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}%)")
    return tot


def smooth_images(g: torch.Generator, n: int, size: int, channels: int,
                  dev) -> torch.Tensor:
    """(n, size, size, channels) float32 in [0, 255]: bicubic-upsampled
    coarse noise plus two sharp-edged rectangles and fine noise per image
    (textured regions and edges, what the classic algorithms are told
    apart on)."""
    from tpusr_torch.core.resize import resize
    coarse = torch.rand((n, size // 16, size // 16, channels), generator=g,
                        device=dev)
    img = resize(coarse, (size, size), "bicubic") * 180.0 + 30.0
    q = size // 8
    for i in range(n):
        r, c = (int(v) for v in torch.randint(0, 4 * q, (2,), generator=g,
                                              device=dev))
        img[i, r:r + 3 * q, c:c + 2 * q] += 50.0
        img[i, c:c + 2 * q, r:r + 4 * q] -= 40.0
    img += torch.randn(img.shape, generator=g, device=dev) * 3.0
    return img.clamp(0.0, 255.0)


def graph_ms(launch, n: int = 50, replays: int = 3) -> float:
    """Device ms of one bare kernel launch: ``n`` calls of ``launch()``
    captured in a CUDA graph, its replay timed by CUDA events, so the host's
    enqueue rate does not enter."""
    launch()                                                 # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays)


def check_k4_build_log() -> str:
    """The ``-Xptxas -v`` lines of nlm.cu's kernels: fails on a spill."""
    lines = build_log_lines("nlm")
    spills = [ln.strip() for ln in lines if "spill" in ln]
    check(all(ln.startswith("0 bytes stack frame, 0 bytes spill stores, "
                            "0 bytes spill loads") for ln in spills),
          f"nlm.cu spills: {spills}")
    regs = sorted({int(ln.split("Used ")[1].split()[0]) for ln in lines
                   if "Used " in ln})
    return f"{len(spills)} kernels, 0 spill bytes, {regs} registers"


def phase_k4(dev) -> dict:
    """K4 against its twin at K4_SIZES, timed as a wrapper call (``ms``) and
    as a bare launch (``kernel_ms``, graph_ms) at both configurations, with
    the bit-for-bit repeat check."""
    from tpusr_torch.classic.algorithms import estimate_sigma
    from tpusr_torch.core import nlm
    from tpusr_torch.core.nlm import nl_means_denoise, nlm_denoise
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[K4] nlm.cu: {check_k4_build_log()}")
    g = torch.Generator(device=dev).manual_seed(4)
    rec = {}
    for size in K4_SIZES:
        x = (smooth_images(g, 1, size, 1, dev)[0, :, :, 0] / 255.0).contiguous()
        sigma = estimate_sigma(x)
        h = 1.15 * sigma
        y = nlm_denoise(x, sigma, h)
        yp = nl_means_denoise(x, sigma, h)
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        check(bool(torch.isfinite(y).all()) and torch.allclose(
            y, yp, rtol=0, atol=K4_ATOL),
            f"K4 differs from its twin at {size}^2: max|err| {err} > {K4_ATOL}")
        if size in (CLASSIC_LR, K4_SIZES[-1]):
            check(torch.equal(nlm_denoise(x, sigma, h), y),
                  f"K4 is not bit-for-bit repeatable at {size}^2")
        ms = time_ms(lambda: nlm_denoise(x, sigma, h))
        pms = time_ms(lambda: nl_means_denoise(x, sigma, h), max_iters=5)
        ops, exps, nbytes = nlm_work(size, size)
        bms, by = bound(ops, nbytes, "fp32", sfu_ops=exps)
        rows, split = nlm.launch_config(size, size, n_sms)
        gx, gy = nlm.grid(size, size, rows, split)
        if size == CLASSIC_LR:
            check(gx * gy >= n_sms, f"K4 at {size}^2 launches {gx * gy} "
                                    f"blocks for {n_sms} SMs")
        out = torch.empty_like(x)
        per_config = {}
        for r, s in nlm.CONFIGS:
            per_config[(r, s)] = graph_ms(
                lambda: nlm.launch(x, sigma, h, out, r, s))
            check(torch.allclose(out, yp, rtol=0, atol=K4_ATOL),
                  f"K4 config {(r, s)} differs from its twin at {size}^2")
        kms = per_config[(rows, split)]
        print(f"[K4] {size}x{size} sigma {float(sigma):.4f} max|err| {err:.3g}"
              f"  call {ms:.4f} ms ({100 * bms / ms:.2f}% of bound)  kernel "
              f"{kms:.4f} ms ({100 * bms / kms:.2f}%)  twin {pms:.4f} ms  "
              f"bound {bms:.4f} ms ({by}: {ops / 1e9:.2f} GFLOP fp32 at 67 "
              f"TFLOP/s, {exps / 1e6:.1f} M expf at "
              f"{PEAK_OPS_PER_S['sfu'] / 1e12:.2f} T/s, {nbytes / 1e6:.2f} MB "
              f"at 3.35 TB/s); config rows {rows} split {split}, "
              f"{gx}x{gy} blocks of {nlm.WARPS} warps")
        print(f"[K4] {size}x{size} kernel ms by (rows, split): "
              + ", ".join(f"{c} {t:.4f}" for c, t in per_config.items()))
        if size == CLASSIC_LR:          # the shape the classic path launches
            rec = {"ms": ms, "kernel_ms": kms, "plain_ms": pms,
                   "bound_ms": bms, "err": 0.0,
                   "t_ops": bms if by == "operations" else 0.0,
                   "t_bytes": bms if by == "bytes" else 0.0}
        rec["err"] = max(rec.get("err", 0.0), err)
        del x, y, yp, out
    return rec


def image_logodds(probs: torch.Tensor) -> torch.Tensor:
    """(N, P, 2) patch probs -> (N,) per-image median patch log-odds."""
    p = probs.double().cpu()
    return torch.log(p[..., 1].clamp_min(1e-9)
                     / p[..., 0].clamp_min(1e-9)).median(dim=1).values


def center_classifier_bias(vgg, trunk: torch.Tensor, per_patch: torch.Tensor):
    """Shift the class-1 logit bias by minus the median over images of the
    per-patch path's median patch log-odds, so that its votes, which decide
    every escalated image and every image of a batch whose guard trips,
    split between the classes (flax's initial weights give each path a
    spread of log-odds narrower than the offset between the two, so no one
    shift splits both). Returns the shift and the two per-image log-odds
    vectors."""
    lt, lp = image_logodds(trunk), image_logodds(per_patch)
    delta = -float(lp.median())
    with torch.no_grad():
        vgg.predictions.bias[1] += delta
    return delta, lt, lp


def plain_edsr(edsr, x: torch.Tensor) -> torch.Tensor:
    """The chained EDSR x4 forward on K2's plain twin: the reference the
    fused SR path is held against."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain as conv
    from tpusr_torch.models.layers import pixel_shuffle

    def c(m, t, relu=False):
        return conv(t, m.kernel, m.bias, relu)

    head = y = c(edsr.head, x)
    for i in range(edsr.num_res_blocks):
        blk = getattr(edsr, f"res{i}")
        y = y + edsr.res_scaling * c(blk.conv2, c(blk.conv1, y, True))
    y = c(edsr.body, y) + head
    y = pixel_shuffle(c(edsr.up0, y), 2)
    y = pixel_shuffle(c(edsr.up1, y), 2)
    return c(edsr.tail, y).clamp(0.0, 1.0)


def on_hwio(plain):
    """A plain int8 twin called as its kernel's wrapper is: the packed
    weights the paths pass are dropped, the twin reads the HWIO ones."""
    return lambda x, w_q, rescale, bias, w_packed=None: plain(x, w_q, rescale,
                                                              bias)


class on_plain_twins:
    """Route the int8 classifier's kernels (K1 in the backbone, K3 for block
    1) to their plain twins on the same device for the duration of a
    reference computation."""

    def __enter__(self):
        from tpusr_torch.core import conv3x3
        from tpusr_torch.models import block1, quant
        self._quant = quant
        self._orig = (quant.conv3x3_int8_requant, quant.block1_int8)
        quant.conv3x3_int8_requant = on_hwio(conv3x3.conv3x3_int8_requant_plain)
        quant.block1_int8 = block1.block1_plain

    def __exit__(self, *exc):
        (self._quant.conv3x3_int8_requant,
         self._quant.block1_int8) = self._orig


SR_STAGES = ("head", "body", "tail", "borders", "sr")
SR_STAGE_CODE = {"head": "K2", "body": "K2 and the residual adds",
                 "tail": "F.conv2d, the composed 7x7 conv (cuDNN)",
                 "borders": "K2 on the slabs", "sr": "the whole forward"}


def sr_stage_diffs(edsr, x: torch.Tensor, images: int = 4) -> dict:
    """max |N = 1 - in the batch of len(x)| of each stage of the fused f32
    SR (``edsr_fast.fused_sr_stages``) over the first ``images`` images,
    each stage run alone on the batch run's input of that stage, and the
    whole forward ("sr") on the image alone."""
    from tpusr_torch.models.edsr_fast import fused_sr_stages
    st = fused_sr_stages(edsr)
    worst = dict.fromkeys(SR_STAGES, 0.0)
    with torch.inference_mode():
        h = st["head"](x)
        y = st["body"](x)
        z = st["tail"](y)
        bz = st["borders"](y, z.clone())
        full = st["clip"](bz.clone())
        for i in range(images):
            one = slice(i, i + 1)
            y1 = st["body"](x[one])
            pairs = {"head": (st["head"](x[one]), h[one]),
                     "body": (y1, y[one]),
                     "tail": (st["tail"](y[one]), z[one]),
                     "borders": (st["borders"](y[one], z[one].clone()), bz[one]),
                     "sr": (st["clip"](st["borders"](y1, st["tail"](y1))),
                            full[one])}
            for k, (a, b) in pairs.items():
                worst[k] = max(worst[k], float((a - b).abs().max()))
    return worst


def phase_slice(cfg: Slice, dev, seed: int, sync, card: str) -> dict:
    from tpusr_torch.core import prng
    from tpusr_torch.core.patches import patchify
    from tpusr_torch.models import EDSR, VGG16Classifier
    from tpusr_torch.models.block1 import extract_patches_reference
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply
    from tpusr_torch.models.layers import pixel_shuffle
    from tpusr_torch.models.quant import (per_patch_int8_probs,
                                          quantized_vgg16_apply)
    from tpusr_torch.models.vgg_trunk import shared_trunk_probs_int8
    from tpusr_torch.pipeline import (FusedSRClassifyPipeline, PipelineServer,
                                      make_serving_pipeline)
    from tpusr_torch.pipeline.cascade import make_cascade_votes

    t0 = time.perf_counter()
    rg, rv = prng.split(prng.PRNGKey(seed))
    edsr = EDSR(scale_factor=cfg.scale, num_res_blocks=cfg.blocks,
                num_filters=cfg.filters, device=dev, key=rg)
    vgg = VGG16Classifier(num_classes=2, dense_units=cfg.dense,
                          widths=cfg.widths, device=dev, key=rv)
    rng = np.random.default_rng(seed)

    def lr_images(n):
        # noise images of different brightness, so that a random classifier
        # sees images that differ by more than the trunk's padding offset
        gain = rng.uniform(0.05, 1.0, (n, 1, 1, 1)).astype(np.float32)
        return rng.random((n, cfg.lr, cfg.lr, 3), dtype=np.float32) * gain

    requests, calib_lr = lr_images(cfg.requests), lr_images(4)
    calib_lr = torch.as_tensor(calib_lr, device=dev)

    # calibration patches as the serve command takes them: the first 64
    # patches of the f32 SR of 4 calibration images
    fn, r = make_fused_sr_apply(edsr)
    with torch.inference_mode():
        sr_cal = pixel_shuffle(fn(calib_lr), r)
        calib = patchify(sr_cal, cfg.patch, cfg.stride)
        calib = calib.reshape((-1,) + calib.shape[2:])[:64]

    def build():
        return make_serving_pipeline(
            edsr, vgg, (cfg.lr, cfg.lr), cfg.scale, patch=cfg.patch,
            stride=cfg.stride, sr_mode="f32", clf_mode="cascade_int8",
            calib_patches=calib, cascade_escalate_frac=cfg.frac,
            cascade_escalate_score="vote_frac",
            cascade_guard_threshold=cfg.guard, device=dev)

    # random weights vote one class; center the last bias on the requests'
    # per-patch log-odds so that both classes get votes
    pipe = build()
    with torch.inference_mode():
        srq = pipe.pre_quant(pipe.sr_apply(torch.as_tensor(requests, device=dev)))
        trunk = shared_trunk_probs_int8(pipe.qtree, srq, cfg.patch, cfg.stride)
        pp = torch.cat([pipe.cascade_votes.per_patch_probs(srq[i:i + 4])
                        for i in range(0, srq.shape[0], 4)])
    delta, lt, lp = center_classifier_bias(vgg, trunk, pp)
    pipe = build()
    del srq, trunk, pp
    sync()
    print(f"[slice] EDSR x{cfg.scale} {cfg.blocks} blocks {cfg.filters} "
          f"filters, VGG16 widths {cfg.widths}, seed {seed}; per-image "
          f"log-odds trunk [{lt.min():+.4f}, {lt.max():+.4f}], per-patch "
          f"[{lp.min():+.4f}, {lp.max():+.4f}]; class-1 bias shifted by "
          f"{delta:+.4f}; set-up {time.perf_counter() - t0:.1f} s")

    # which stage of the fused f32 SR depends on the batch size
    diffs = sr_stage_diffs(edsr, torch.as_tensor(requests[:cfg.batch],
                                                 device=dev))
    first = next((k for k in SR_STAGES if diffs[k] > 0), None)
    print(f"[slice] fused f32 SR, 4 images alone (N = 1) against the same "
          f"images in a batch of {cfg.batch}, each stage on shared inputs: "
          + ", ".join(f"{k} max|d| {v:.3g}" for k, v in diffs.items())
          + (f"; first stage that differs: {first} "
             f"({SR_STAGE_CODE[first]})" if first else
             "; no stage differs"))

    # ---- the main path: 20 requests through the server at batch 16 ----
    votes = pipe.cascade_votes
    votes.guard_trips = 0
    server = PipelineServer(pipe, batch_size=cfg.batch, max_wait_ms=50.0)
    futures = [server.submit(im) for im in requests]
    reset_counts()
    t0 = time.perf_counter()
    with server:
        results = [f.result(timeout=600) for f in futures]
    served_s = time.perf_counter() - t0
    launches = read_counts()
    trips = votes.guard_trips
    last_escalated = votes.last_escalated.cpu()

    # per batch: the trunk (13 K1) and the escalation (K3 + 11 K1); per
    # guard trip: the fallback (K3 + 11 K1)
    n_batches = math.ceil(cfg.requests / cfg.batch)
    per_batch_k1 = len(k1_shapes(cfg))
    per_batch_k2 = sum(m for *_, m in k2_shapes(cfg))
    want = launches_want(
        conv3x3_int8_requant=n_batches * per_batch_k1
        + trips * n_per_patch_k1(cfg),
        conv3x3_bias_act=n_batches * per_batch_k2,
        block1_int8=n_batches + trips)
    print(f"[slice] served {len(results)} requests in {n_batches} batches in "
          f"{served_s:.3f} s; guard trips {trips}; launches {launches} "
          f"(expected {want})")
    check(launches == want, f"launch counts {launches} != {want}")

    srs = np.stack([r["sr"] for r in results])
    classes = np.array([r["class"] for r in results])
    confs = np.array([r["confidence"] for r in results])
    check(srs.shape == (cfg.requests, cfg.hr, cfg.hr, 3), f"SR {srs.shape}")
    check(bool(np.isfinite(srs).all()) and srs.min() >= 0.0 and srs.max() <= 1.0,
          "SR not finite in [0, 1]")
    check(set(classes.tolist()) == {0, 1}, f"classes {classes.tolist()}")
    check(bool(((confs >= 0) & (confs <= 1)).all()), "confidence out of [0, 1]")
    tail = cfg.requests - (n_batches - 1) * cfg.batch
    check(last_escalated.numel() == cfg.escalated()
          and bool((last_escalated < tail).all()),
          f"partial batch escalated {last_escalated.tolist()}")
    print(f"[slice] classes {classes.tolist()}; partial batch (n_valid="
          f"{tail}) escalated {sorted(last_escalated.tolist())}")

    def variant(**stage):
        """The served pipeline's SR and quantizer with another classify
        stage."""
        return FusedSRClassifyPipeline(
            pipe.sr_apply, lr_hw=(cfg.lr, cfg.lr), scale=cfg.scale,
            patch=cfg.patch, stride=cfg.stride, pre_quant=pipe.pre_quant,
            device=dev, **stage)

    def cascade(guard):
        return make_cascade_votes(pipe.qtree, cfg.patch, cfg.stride, cfg.frac,
                                  "vote_frac", guard)

    def all_k1_probs(srq):
        """The per-patch path with block 1 on K1: extracted patches through
        quantized_vgg16_apply."""
        flat = extract_patches_reference(srq, cfg.patch, cfg.stride)
        return quantized_vgg16_apply(pipe.qtree, flat).reshape(
            srq.shape[0], cfg.n_patches(), -1)

    # ---- correctness of the served results against references ----
    batch = torch.as_tensor(requests[:cfg.batch], device=dev)
    with torch.inference_mode():
        sr, cls_b, conf_b = pipe(batch, n_valid=cfg.batch)
        check(votes.last_escalated.numel() == cfg.escalated(),
              "full batch escalation count")
        check(np.array_equal(cls_b.cpu().numpy(), classes[:cfg.batch])
              and np.allclose(conf_b.cpu().numpy(), confs[:cfg.batch],
                              rtol=0, atol=1e-6),
              "served results differ from a direct call on the same batch")
        sr_err = float((sr[:2] - plain_edsr(edsr, batch[:2])).abs().max())
        check(sr_err <= SR_ATOL, f"SR vs plain chained EDSR: {sr_err}")
        srq = pipe.pre_quant(sr)
        with on_plain_twins():
            cls_p, conf_p = votes(srq, cfg.batch)
        check(torch.equal(cls_p, cls_b)
              and torch.allclose(conf_p, conf_b, rtol=0, atol=1e-6),
              "cascade on K1's and K3's twins differs from the served cascade")
        probs_k3 = per_patch_int8_probs(pipe.qtree, srq, cfg.patch, cfg.stride)
        check(torch.equal(probs_k3, all_k1_probs(srq)),
              "per_patch_int8_probs (K3 + 11 K1) != patches + 13 K1")
        tripped = variant(cascade_votes=cascade(0.0))    # always trips
        per_patch = variant(trunk_probs=all_k1_probs)
        _, cls_g, conf_g = tripped(batch)
        _, cls_pp, conf_pp = per_patch(batch)
        check(tripped.cascade_votes.guard_trips == 1, "guard 0.0 did not trip")
        check(torch.equal(cls_g, cls_pp) and torch.equal(conf_g, conf_pp),
              "guard-tripped cascade differs from the all-K1 per-patch path")
    print(f"[slice] SR vs plain chained EDSR max|err| {sr_err:.3g} (atol "
          f"{SR_ATOL}); cascade on K1's and K3's twins equal; per-patch probs "
          f"K3 + 11 K1 == patches + 13 K1 on {cfg.batch} images (torch.equal);"
          f" guard-tripped cascade == the all-K1 per-patch path (classes "
          f"{cls_pp.tolist()})")

    # ---- steady-state time per batch and per stage ----
    # the served mode, and the same cascade with the guard off: the time of
    # a batch on which the guard stays silent
    unguarded = variant(cascade_votes=cascade(None))
    with torch.inference_mode():
        batch_ms = min(host_ms(lambda: pipe(batch, n_valid=cfg.batch), sync)
                       for _ in range(3))
        silent_ms = min(host_ms(lambda: unguarded(batch, n_valid=cfg.batch),
                                sync) for _ in range(3))
        srq = pipe.pre_quant(pipe.sr_apply(batch))
        n_esc = cfg.escalated()
        stages = {
            "sr": time_ms(lambda: pipe.sr_apply(batch), max_iters=5),
            "quantize": time_ms(lambda: pipe.pre_quant(sr), max_iters=5),
            "trunk": time_ms(lambda: shared_trunk_probs_int8(
                pipe.qtree, srq, cfg.patch, cfg.stride), max_iters=5),
            "escalation": time_ms(lambda: votes.per_patch_probs(srq[:n_esc]),
                                  max_iters=5),
            "guard_fallback": time_ms(lambda: votes.per_patch_probs(srq),
                                      max_iters=3),
        }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[slice] {card}, batch {cfg.batch} (host clock, best of 3): served mode "
          f"{batch_ms:.2f} ms per batch, {cfg.batch / batch_ms * 1e3:.1f} img/s "
          f"(guard tripped on {trips} of {n_batches} served batches); guard "
          f"silent {silent_ms:.2f} ms, {cfg.batch / silent_ms * 1e3:.1f} img/s; "
          f"stages (device ms) "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; peak memory {peak_gb:.1f} GB")
    return launches, {"edsr": edsr, "vgg": vgg, "calib": calib,
                      "calib_lr": calib_lr, "batch": batch, "sr_f32": sr,
                      "pipe": pipe}


def phase_bf16(cfg: Slice, dev, state: dict, sync, card: str) -> dict:
    """One batch of 16 through the bf16 SR serving mode on the slice's
    weights and calibration patches."""
    from tpusr_torch.pipeline import make_serving_pipeline

    def build(frac, guard, sr_mode="bf16"):
        return make_serving_pipeline(
            state["edsr"], state["vgg"], (cfg.lr, cfg.lr), cfg.scale,
            patch=cfg.patch, stride=cfg.stride, sr_mode=sr_mode,
            clf_mode="cascade_int8", calib_patches=state["calib"],
            cascade_escalate_frac=frac, cascade_escalate_score="vote_frac",
            cascade_guard_threshold=guard, device=dev)

    pipe = build(cfg.bf16_frac, cfg.guard)
    batch = state["batch"]
    votes = pipe.cascade_votes
    # ---- the main path: one full batch through the bf16 serving mode ----
    reset_counts()
    sr, cls, conf = pipe(batch, n_valid=cfg.batch)
    sync()
    launches = read_counts()
    trips = votes.guard_trips
    per_batch_k2 = sum(m for *_, m in k2_shapes(cfg))
    want = launches_want(
        conv3x3_int8_requant=len(k1_shapes(cfg)) + trips * n_per_patch_k1(cfg),
        conv3x3_bias_act_bf16=per_batch_k2, block1_int8=1 + trips)
    print(f"[bf16] sr_mode=bf16 cascade_int8 vote_frac frac {cfg.bf16_frac} "
          f"guard {cfg.guard}: one batch of {cfg.batch}; guard trips {trips}; "
          f"launches {launches} (expected {want})")
    check(launches == want, f"bf16 launch counts {launches} != {want}")
    check(votes.last_escalated.numel()
          == math.ceil(cfg.batch * cfg.bf16_frac - 1e-9), "bf16 escalation count")
    check(sr.dtype == torch.float32 and tuple(sr.shape)
          == (cfg.batch, cfg.hr, cfg.hr, 3), f"bf16 SR {sr.dtype} {tuple(sr.shape)}")
    check(bool(torch.isfinite(sr).all()) and float(sr.min()) >= 0.0
          and float(sr.max()) <= 1.0, "bf16 SR not finite in [0, 1]")
    check(bool(((conf >= 0) & (conf <= 1)).all()), "confidence out of [0, 1]")

    # the bf16 SR against the f32 SR on the same LR batch, and the classes
    # against the f32-SR cascade with the same settings
    sr32 = state["sr_f32"]
    mse = float(((sr - sr32) ** 2).mean())
    psnr = 10.0 * math.log10(1.0 / max(mse, 1e-30))
    check(psnr >= BF16_SR_MIN_PSNR, f"bf16 SR vs f32 SR PSNR {psnr:.2f} dB "
                                    f"< {BF16_SR_MIN_PSNR}")
    _, cls32, _ = build(cfg.bf16_frac, cfg.guard, "f32")(batch, n_valid=cfg.batch)
    n_diff = int((cls != cls32).sum())
    unguarded = build(cfg.bf16_frac, None)
    with torch.inference_mode():
        guarded_ms = min(host_ms(lambda: pipe(batch, n_valid=cfg.batch), sync)
                         for _ in range(3))
        silent_ms = min(host_ms(lambda: unguarded(batch, n_valid=cfg.batch), sync)
                        for _ in range(3))
        sr_ms = time_ms(lambda: pipe.sr_apply(batch), max_iters=5)
    print(f"[bf16] SR PSNR against the f32 SR {psnr:.2f} dB (min "
          f"{BF16_SR_MIN_PSNR}); classes {cls.tolist()}, {n_diff} of "
          f"{cfg.batch} differ from the f32-SR cascade {cls32.tolist()}")
    print(f"[bf16] {card}, batch {cfg.batch} (host clock, best of 3): guard on "
          f"{guarded_ms:.2f} ms per batch, {cfg.batch / guarded_ms * 1e3:.1f} "
          f"img/s (tripped {trips} of 1); guard off {silent_ms:.2f} ms, "
          f"{cfg.batch / silent_ms * 1e3:.1f} img/s; bf16 SR stage "
          f"{sr_ms:.2f} ms (device)")
    return launches


class dequant_on_plain_twin:
    """Route the int8 EDSR's 3x3 convs to the dequant conv's plain twin (on
    the same device) for the duration of a reference computation."""

    def __enter__(self):
        from tpusr_torch.core import conv3x3
        from tpusr_torch.models import edsr_quant
        self._mod, self._orig = edsr_quant, edsr_quant.conv3x3_int8_dequant
        edsr_quant.conv3x3_int8_dequant = on_hwio(
            conv3x3.conv3x3_int8_dequant_plain)

    def __exit__(self, *exc):
        self._mod.conv3x3_int8_dequant = self._orig


def psnr_db(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-30))


def phase_int8_sr(cfg: Slice, dev, state: dict, sync, card: str):
    """The dequant conv and the int8 tail against their twins, then one batch
    of 16 of each int8-SR row of bench.py. Returns the dequant conv's
    launches over the three rows and its record (one batch's launches)."""
    from tpusr_torch.core.conv3x3 import (conv3x3_int8_dequant,
                                          conv3x3_int8_dequant_plain,
                                          pack_int8_kernel)
    from tpusr_torch.models.edsr_quant import (tail_conv_int8,
                                               tail_conv_int8_plain)
    from tpusr_torch.pipeline import make_serving_pipeline

    g = torch.Generator(device=dev).manual_seed(6)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
           "t_ops": 0.0, "t_bytes": 0.0, "gemm_library_ms": 0.0}
    for where, shape, mult in dequant_shapes(cfg):
        x, wq, rs, b = _int8_operands(shape, g, dev)
        wp = pack_int8_kernel(wq)
        y = conv3x3_int8_dequant(x, wq, rs, b, wp)
        yp = conv3x3_int8_dequant_plain(x, wq, rs, b)
        torch.cuda.synchronize()
        n_diff = int((y.view(torch.int16) != yp.view(torch.int16)).sum())
        check(n_diff == 0, f"dequant conv differs from its twin at {shape}: "
                           f"{n_diff} values")
        ms = time_ms(lambda: conv3x3_int8_dequant(x, wq, rs, b, wp))
        pms = time_ms(lambda: conv3x3_int8_dequant_plain(x, wq, rs, b),
                      min_total_ms=10.0, max_iters=5)
        lms = int_mm_yardstick(x, wq, rs, b, y, dequant=True)
        n, h, w, cin, cout = shape
        ops = 2.0 * n * h * w * 9 * cin * cout
        nbytes = n * h * w * (cin + 2 * cout) + 9 * cin * cout + 8 * cout
        bms, by = bound(ops, nbytes, "int8")
        print(f"[int8-sr] dequant conv {where:8s} {str(shape):26s} bit-equal "
              f"to its twin (bf16)  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} "
              f"TOP/s, {100 * bms / ms:.1f}% of bound)  twin {pms:.4f} ms  "
              "_int_mm GEMM " + (f"{lms:.4f} ms" if lms else "n/a (K % 8)")
              + f"  bound {bms:.4f} ms ({by})  x{mult}/batch")
        tot["ms"] += mult * ms
        tot["plain_ms"] += mult * pms
        tot["bound_ms"] += mult * bms
        tot["gemm_library_ms"] += mult * (lms or 0.0)
        tot["t_" + ("ops" if by == "operations" else by)] += mult * bms
        del x, wq, wp, y, yp
    print(f"[int8-sr] dequant conv per batch of {cfg.batch}: kernel "
          f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f}%), _int_mm GEMM "
          f"{tot['gemm_library_ms']:.3f} ms (res+body shapes; the Cin = 3 "
          f"head has K = 27)")
    n, h, f = cfg.batch, cfg.lr, cfg.filters
    x8 = torch.randint(-127, 128, (n, h, h, f), generator=g, device=dev,
                       dtype=torch.int8)
    kq = torch.randint(-127, 128, (7, 7, f, 3 * cfg.scale ** 2), generator=g,
                       device=dev, dtype=torch.int8)
    check(torch.equal(tail_conv_int8(x8, kq), tail_conv_int8_plain(x8, kq)),
          "int8 7x7 tail (torch._int_mm) != its float64 twin")
    tail_ms = time_ms(lambda: tail_conv_int8(x8, kq), max_iters=10)
    tail_pms = time_ms(lambda: tail_conv_int8_plain(x8, kq), max_iters=5)
    print(f"[int8-sr] 7x7 tail {tuple(x8.shape)} -> {tuple(kq.shape[-1:])} "
          f"channels: torch._int_mm over the im2col equals its float64 twin; "
          f"{tail_ms:.4f} ms, twin {tail_pms:.4f} ms")
    del x8, kq

    batch, sr32 = state["batch"], state["sr_f32"]
    per_batch_k1 = len(k1_shapes(cfg))
    band = 4 * 3          # pad 3 cells of the composed tail, x4
    interior = (slice(None), slice(band, -band), slice(band, -band))
    dequant_launches = 0
    for row, (border, clf_mode) in INT8_SR_ROWS.items():
        pipe = make_serving_pipeline(
            state["edsr"], state["vgg"], (cfg.lr, cfg.lr), cfg.scale,
            patch=cfg.patch, stride=cfg.stride, sr_mode="int8",
            clf_mode=clf_mode, calib_lr=state["calib_lr"],
            calib_patches=state["calib"], sr_border_correction=border,
            device=dev)
        # ---- the main path: one batch of this row ----
        reset_counts()
        sr, cls, conf = pipe(batch)
        sync()
        launches = read_counts()
        per_patch = clf_mode == "per_patch_int8"
        want = launches_want(
            conv3x3_int8_dequant=2 * cfg.blocks + 2,
            conv3x3_bias_act_bf16=12 if border else 0,
            conv3x3_int8_requant=(n_per_patch_k1(cfg) if per_patch
                                  else per_batch_k1 - n_per_patch_k1(cfg)),
            block1_int8=1 if per_patch else 0)
        check(launches == want, f"{row} launch counts {launches} != {want}")
        dequant_launches += launches["conv3x3_int8_dequant"]
        check(sr.dtype == torch.float32 and tuple(sr.shape)
              == (cfg.batch, cfg.hr, cfg.hr, 3), f"{row} SR {tuple(sr.shape)}")
        check(bool(torch.isfinite(sr).all()) and float(sr.min()) >= 0.0
              and float(sr.max()) <= 1.0, f"{row} SR not finite in [0, 1]")
        check(bool(((conf >= 0) & (conf <= 1)).all()), f"{row} confidence")
        with torch.inference_mode(), dequant_on_plain_twin():
            sr_twin = pipe.sr_apply(batch[:2])
        check(torch.equal(sr[:2], sr_twin),
              f"{row} SR differs from the same SR on the dequant conv's twin")
        p_all, p_in = psnr_db(sr, sr32), psnr_db(sr[interior], sr32[interior])
        check(p_in >= INT8_SR_MIN_PSNR, f"{row} interior SR PSNR {p_in:.2f} dB "
                                        f"< {INT8_SR_MIN_PSNR}")
        with torch.inference_mode():
            batch_ms = min(host_ms(lambda: pipe(batch), sync) for _ in range(3))
            sr_ms = time_ms(lambda: pipe.sr_apply(batch), max_iters=5)
        print(f"[int8-sr] {row}: launches {launches}; SR == SR on the dequant "
              f"twin (2 images); PSNR against the f32 SR {p_all:.2f} dB, "
              f"interior {p_in:.2f} dB (min {INT8_SR_MIN_PSNR}); classes "
              f"{cls.tolist()}")
        print(f"[int8-sr] {row}: {card}, batch {cfg.batch} (host clock, best "
              f"of 3) {batch_ms:.2f} ms per batch, "
              f"{cfg.batch / batch_ms * 1e3:.1f} img/s; int8 SR stage "
              f"{sr_ms:.2f} ms (device)")
        del pipe, sr
    torch.cuda.empty_cache()
    return dequant_launches, tot


def phase_f32_modes(cfg: Slice, dev, state: dict, sync, card: str) -> None:
    """shared_trunk_f32, classify_chunks and entry() on the card."""
    import copy

    from tpusr_torch.entry import entry
    from tpusr_torch.models.vgg_trunk import shared_trunk_probs_f32
    from tpusr_torch.pipeline import (FusedSRClassifyPipeline,
                                      make_serving_pipeline)

    edsr, vgg, batch = state["edsr"], state["vgg"], state["batch"]
    per_batch_k2 = sum(m for *_, m in k2_shapes(cfg))

    def build(clf_mode):
        return make_serving_pipeline(
            edsr, vgg, (cfg.lr, cfg.lr), cfg.scale, patch=cfg.patch,
            stride=cfg.stride, sr_mode="f32", clf_mode=clf_mode, device=dev)

    # ---- shared_trunk_f32: one batch ----
    pipe = build("shared_trunk_f32")
    reset_counts()
    sr, cls, conf = pipe(batch)
    sync()
    launches = read_counts()
    want = launches_want(conv3x3_bias_act=per_batch_k2)
    check(launches == want, f"shared_trunk_f32 launches {launches} != {want}")
    check(bool(((conf >= 0) & (conf <= 1)).all()), "trunk f32 confidence")
    vgg64 = copy.deepcopy(vgg).double()
    with torch.inference_mode():
        probs = shared_trunk_probs_f32(vgg, sr[:2], cfg.patch, cfg.stride)
        probs64 = shared_trunk_probs_f32(vgg64, sr[:2], cfg.patch, cfg.stride)
        trunk_ms = min(host_ms(lambda: pipe(batch), sync) for _ in range(3))
    del vgg64
    err = float((probs.double() - probs64).abs().max())
    check(probs.shape == (2, cfg.n_patches(), 2) and err <= TRUNK_F32_ATOL,
          f"shared_trunk_f32 probs against float64: {err} > {TRUNK_F32_ATOL}")
    print(f"[f32-modes] shared_trunk_f32: launches {launches}; patch probs "
          f"against the float64 trunk max|err| {err:.3g} (atol "
          f"{TRUNK_F32_ATOL}); classes {cls.tolist()}; {card}, batch "
          f"{cfg.batch} {trunk_ms:.2f} ms per batch (host clock, best of 3)")

    # ---- per_patch_f32 with classify_chunks 4 against 1 ----
    pp = build("per_patch_f32")
    chunked = FusedSRClassifyPipeline(
        pp.sr_apply, clf_apply=pp.clf_apply, lr_hw=(cfg.lr, cfg.lr),
        scale=cfg.scale, patch=cfg.patch, stride=cfg.stride,
        classify_chunks=4, device=dev)
    _, cls1, conf1 = pp(batch)
    _, cls4, conf4 = chunked(batch)
    # cuDNN may pick another algorithm for 400 patches than for 1600
    d = float((conf1 - conf4).abs().max())
    check(torch.equal(cls1, cls4) and d <= 1e-6,
          f"classify_chunks=4 differs from 1: max|d conf| {d}")
    with torch.inference_mode():
        ms1 = min(host_ms(lambda: pp(batch), sync) for _ in range(2))
        ms4 = min(host_ms(lambda: chunked(batch), sync) for _ in range(2))
    print(f"[f32-modes] per_patch_f32: classify_chunks=4 == 1 (classes equal, "
          f"max|d conf| {d:.3g}); {ms1:.2f} ms and {ms4:.2f} ms per batch of "
          f"{cfg.batch} (host clock, best of 2)")
    del pp, chunked

    # ---- entry(): the f32 reference path ----
    fn, args = entry(device=dev)
    reset_counts()
    sr_e, cls_e, conf_e = fn(*args)
    sync()
    launches = read_counts()
    shapes = [tuple(t.shape) for t in (sr_e, cls_e, conf_e)]
    check(shapes == [(2, 512, 512, 3), (2,), (2,)], f"entry() shapes {shapes}")
    check(bool(torch.isfinite(sr_e).all()) and float(sr_e.min()) >= 0.0
          and float(sr_e.max()) <= 1.0, "entry() SR not finite in [0, 1]")
    want = launches_want(conv3x3_bias_act=2 * 16 + 5)  # chained EDSR x4
    check(launches == want, f"entry() launches {launches} != {want}")
    print(f"[f32-modes] entry(): {shapes}, classes {cls_e.tolist()}, "
          f"confidences {[round(float(c), 6) for c in conf_e]}; launches "
          f"{launches}")


def phase_classic(dev, seed: int, sync, card: str) -> int:
    """The classic-SR comparison on the card over 16 pairs; returns the K4
    launches it made."""
    from tpusr_torch.classic.harness import (CLASSIC_ALGORITHMS, pair_metrics,
                                             run_classic_comparison, sr_images)
    from tpusr_torch.core import nlm
    from tpusr_torch.core.resize import resize

    g = torch.Generator(device=dev).manual_seed(seed)
    hr = torch.round(smooth_images(g, CLASSIC_PAIRS, CLASSIC_HR, 3, dev))
    lr = torch.round(resize(hr, (CLASSIC_LR, CLASSIC_LR), "area")).clamp(0, 255)
    hr_u8 = hr.to(torch.uint8).cpu().numpy()
    lr_u8 = lr.to(torch.uint8).cpu().numpy()
    del hr, lr
    repeats = 1

    # ---- the main path: the comparison over 16 pairs on the card ----
    nlm.reset_launch_counts()
    t0 = time.perf_counter()
    summary, ranked, _, stats = run_classic_comparison(
        list(hr_u8), list(lr_u8), time_repeats=repeats, device=dev)
    sync()
    wall_s = time.perf_counter() - t0
    launches = nlm.LAUNCHES["nlm_denoise"]
    # per pair: the scored run, the warm-up and the timed repeats; once per
    # shape: the memory measurement
    want = CLASSIC_PAIRS * (2 + repeats) + 1
    print(f"[classic] {CLASSIC_PAIRS} pairs HR {CLASSIC_HR}^2 / LR "
          f"{CLASSIC_LR}^2 in {wall_s:.1f} s; K4 launches {launches} "
          f"(expected {want})")
    check(launches == want, f"K4 launches {launches} != {want}")
    check(set(summary) == set(CLASSIC_ALGORITHMS), f"algorithms {set(summary)}")
    for alg in CLASSIC_ALGORITHMS:
        check(all(math.isfinite(v) for v in stats["psnr"][alg]),
              f"{alg}: PSNR not finite")
        check(all(t > 0 for t in stats["time"][alg]), f"{alg}: time")
        check(all(m > 0 for m in stats["memory"][alg]), f"{alg}: memory")
    # the reference's quirk: NLM's [0, 1] output scored against [0, 255]
    check(summary["nlm"]["psnr_mean"] < 10.0,
          f"NLM PSNR {summary['nlm']['psnr_mean']} >= 10")
    check(summary["bicubic"]["psnr_mean"] > 20.0,
          f"bicubic PSNR {summary['bicubic']['psnr_mean']} <= 20")

    # one pair on the card against the same harness on the CPU (plain twins)
    cpu = torch.device("cpu")
    hr0, lr0 = (torch.as_tensor(a.astype(np.float32)) for a in (hr_u8[0], lr_u8[0]))
    with torch.inference_mode():
        on_card = sr_images(hr0.to(dev), lr0.to(dev))
        on_cpu = sr_images(hr0, lr0)
    worst = {}
    for alg in CLASSIC_ALGORITHMS:
        a, b = on_card[alg].cpu(), on_cpu[alg]
        d = (a - b).abs()
        if alg == "nlm":     # a float image: K4 and the lanczos matmul
            check(float(d.max()) <= 1e-4, f"nlm on the card vs the CPU: "
                                          f"{float(d.max())}")
            worst[alg] = f"{float(d.max()):.2g}"
        else:                # stored uint8 values: a level at most, <= 0.1%
            n = int((d > 0).sum())
            check(float(d.max()) <= 1.0 and n <= 0.001 * d.numel(),
                  f"{alg} on the card vs the CPU: {n} values differ, max "
                  f"{float(d.max())}")
            worst[alg] = n
    metrics = pair_metrics(hr0, on_cpu)
    psnr_cpu = {a: float(metrics[a]["psnr"]) for a in CLASSIC_ALGORITHMS}
    print(f"[classic] pair 0 on the card vs the CPU: values one level apart "
          f"{worst}; PSNR card "
          + ", ".join(f"{a} {stats['psnr'][a][0]:.3f}" for a in CLASSIC_ALGORITHMS)
          + "; CPU " + ", ".join(f"{a} {psnr_cpu[a]:.3f}" for a in CLASSIC_ALGORITHMS))
    for alg in CLASSIC_ALGORITHMS:
        check(abs(stats["psnr"][alg][0] - psnr_cpu[alg]) <= 1e-3
              * abs(psnr_cpu[alg]) + 1e-3, f"{alg}: PSNR card vs CPU")
    print(f"[classic] {card}: ranking "
          + ", ".join(f"{a} {s:.4f}" for a, s in ranked))
    print("[classic] per algorithm (mean over pairs): "
          + "; ".join(f"{a} {summary[a]['time_mean'] * 1e3:.3f} ms "
                      f"{summary[a]['memory_mean'] / 1e6:.1f} MB "
                      f"PSNR {summary[a]['psnr_mean']:.2f} SSIM "
                      f"{summary[a]['ssim_mean']:.4f}" for a in CLASSIC_ALGORITHMS))
    return launches


# ---------------------------------------------------------------- inference

@dataclass(frozen=True)
class InferenceSlice:
    """Patch and full-image SR (``pipeline/inference.py``) on one 128^2 LR
    image, at full width from ``--seed``: EDSR x4 (16 blocks, 64 filters)
    at the facade's patch 48, stride 24 (25 patches); SRCNN (96/32 filters)
    to 512^2 at patch 33, stride 14; ESRGAN at ``ESRGANConfig`` (growth 8, 4
    RRDB, x2) by patches at the ESRGAN facade's 48/24 and on the full image
    at attention block 4096 (16,384 tokens at the trunk, 65,536 at
    ``upsample_0``); ESRGAN at the class defaults (growth 32, 23 RRDB, x2)
    on the full image."""
    lr: int = 128
    patch: int = 48
    stride: int = 24
    srcnn_patch: int = 33
    srcnn_stride: int = 14
    attention_block: int = 4096


def k2_forward_bound(x: torch.Tensor, k: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """The largest difference (float64, per output) of two fp32 results of
    K2's function (3x3 SAME conv + bias, with or without ReLU) that sum the
    9*C products in any order and round the bias add once each:
    ``k2_f32_bound`` = 2 * 9C * 2^-24 * S plus 2^-23 (S + |b|), S =
    conv(|x|, |k|), |y| <= S + |b|. The ReLU is 1-Lipschitz."""
    bnd = k2_f32_bound(x, k)
    return bnd * (1 + 1 / (9 * x.shape[-1])) + 2 * FP32_UNIT * b.double().abs()


def models_on_k2_twin():
    """Route the models' 3x3 convs (``edsr.conv3x3``: EDSR's and ESRGAN's)
    to K2's plain twin while open: the reference run of an SR path."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain
    from tpusr_torch.models import edsr
    return patched(edsr, conv3x3_bias_act=lambda _k2: conv3x3_bias_act_plain)


class k2_against_twin:
    """While open, every K2 launch of the models' convs also runs the plain
    twin on the same input; ``rows`` holds, per launch, the conv's shape (N,
    H, W, Cin, Cout), its ReLU, max |K2 - twin|, the largest per-output
    bound (``k2_forward_bound``; ``k2_bf16_tolerance`` for a K2-bf16
    launch) and whether every output lies within it."""

    def __enter__(self):
        from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain
        from tpusr_torch.models import edsr
        self.rows = []
        self._mod, self._orig = edsr, edsr.conv3x3_bias_act

        def call(x, k, b, relu=False):
            y = self._orig(x, k, b, relu)
            yp = conv3x3_bias_act_plain(x, k, b, relu)
            err = (y.double() - yp.double()).abs()
            bnd = (k2_bf16_tolerance(x, k, y, yp) if x.dtype == torch.bfloat16
                   else k2_forward_bound(x, k, b))
            self.rows.append(((*x.shape, k.shape[-1]), bool(relu),
                              float(err.max()), float(bnd.max()),
                              bool((err <= bnd).all())))
            return y
        edsr.conv3x3_bias_act = call
        return self

    def __exit__(self, *exc):
        self._mod.conv3x3_bias_act = self._orig


def esrgan_launches(rrdb: int, scale: int) -> int:
    """K2 launches of one ESRGAN generator forward: the initial conv, 15 per
    RRDB, the trunk conv, one per upsample block and the two final convs."""
    return 1 + 15 * rrdb + 1 + int(math.log2(scale)) + 2


def k2_shape_times(shapes: dict, dev) -> dict:
    """K2 against its plain twin (max |err| <= K2_ATOL on random inputs) at
    each (shape, relu) of ``shapes``, timed beside the twin and ``F.conv2d``
    fp32; returns {(shape, relu): times}."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for shape, relu in sorted(shapes):
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), generator=g, device=dev)
        k = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
             * math.sqrt(2.0 / (9 * cin)))
        b = torch.randn(cout, generator=g, device=dev) * 0.1
        err = float((conv3x3_bias_act(x, k, b, relu)
                     - conv3x3_bias_act_plain(x, k, b, relu)).abs().max())
        check(err <= K2_ATOL, f"K2 differs from its twin at {shape}: max|err| "
                              f"{err} > {K2_ATOL}")
        x_nchw, k_oihw = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous()
        ops, nbytes = conv_work(shape, 4, n_vecs=1)
        bms, by = bound(ops, nbytes, "fp32")
        out[(shape, relu)] = {
            "ms": time_ms(lambda: conv3x3_bias_act(x, k, b, relu),
                          min_total_ms=10.0),
            "plain_ms": time_ms(lambda: conv3x3_bias_act_plain(x, k, b, relu),
                                min_total_ms=10.0),
            "library_ms": time_ms(lambda: F.conv2d(x_nchw, k_oihw, b,
                                                   padding=1),
                                  min_total_ms=10.0),
            "bound_ms": bms, "bound_by": by, "err": err, "ops": ops}
        del x, k
    torch.cuda.empty_cache()
    return out


TAIL_F64_RATIO = 2.0     # g32's tail: K2's mean distance from float64 / the twin's


def check_chaotic_generator(gen, lr: torch.Tensor, block: int,
                            out: torch.Tensor, ref: torch.Tensor) -> str:
    """For a generator whose output does not hold the first-order tolerance
    (random weights at 23 RRDB grow the trunk to |x| ~ 200 and the features
    at ``upsample_0`` to ~300, where the attentions' logits spread by
    ~2.5e4 and ~6e4 in a row: hard maxes that turn fp32 rounding, in any
    implementation, into O(0.1-1) output differences), held in two parts,
    each from an input shared by K2 and the twin. The trunk (the 1 + 15 *
    RRDB + 1 launches before the first attention) on K2 against the twin's
    and a float64 run's at launches x K2_ATOL (first order, gain 1, no
    [0, 1] map there). The tail (both attentions, the upsample blocks and
    the final convs), run from the twin's trunk output on K2, on the twin
    and in float64: K2's mean distance from float64 over the image at most
    ``TAIL_F64_RATIO`` x the twin's (both sum the same products in fp32 in
    other orders, and share the attentions' fp32 rounding). The full
    output's distance from a float64 run is reported for K2 and the twin."""
    from tpusr_torch.pipeline.inference import _largest_divisor_at_most
    x = lr[None] * 2.0 - 1.0
    n_trunk = 2 + 15 * gen.num_rrdb_blocks
    n_tail = esrgan_launches(gen.num_rrdb_blocks, gen.scale_factor) - n_trunk
    tol = n_trunk * K2_ATOL
    spreads = []

    def image(y):
        return ((y[0] + 1.0) / 2.0).clamp(0.0, 1.0)

    def attend(layer, y):
        # the logits (g f^T) of the first 2048 queries: their spread in a
        # row is how hard the softmax is
        q = layer.g(y).reshape(-1, layer.channels // 8)[:2048]
        logits = q @ layer.f(y).reshape(-1, layer.channels // 8).T
        spreads.append(float((logits.amax(-1) - logits.amin(-1)).max()))
        return type(gen)._attend(gen, layer, y)
    saved = gen.attention_block_size
    gen.attention_block_size = _largest_divisor_at_most(x.shape[1] * x.shape[2],
                                                        block)
    try:
        with torch.inference_mode():
            t_k2 = gen.trunk(x)
            with models_on_k2_twin():
                t_tw = gen.trunk(x)
            tail_k2 = image(gen.tail(t_tw))
            with models_on_k2_twin():
                tail_tw = image(gen.tail(t_tw))
                gen.double()
                t_64 = gen.trunk(x.double())
                o_64 = image(gen(x.double()))
                gen._attend = attend
                tail_64 = image(gen.tail(t_tw.double()))
    finally:
        gen.__dict__.pop("_attend", None)
        gen.float()
        gen.attention_block_size = saved
    e_tw = float((t_k2 - t_tw).abs().max())
    e_64 = float((t_k2.double() - t_64).abs().max())
    check(e_tw <= tol and e_64 <= tol,
          f"trunk on K2 against the twin {e_tw}, float64 {e_64} > {tol}")
    d_k2, d_tw = ((t.double() - tail_64).abs() for t in (tail_k2, tail_tw))
    m_k2, m_tw = float(d_k2.mean()), float(d_tw.mean())
    check(m_k2 <= TAIL_F64_RATIO * m_tw,
          f"tail from the twin's trunk: K2's mean distance from float64 "
          f"{m_k2} > {TAIL_F64_RATIO} x the twin's {m_tw}")
    e_tw64 = float((t_tw.double() - t_64).abs().max())
    return (f"trunk ({n_trunk} launches, max|x| {float(t_64.abs().max()):.1f}) "
            f"against the twin's max|err| {e_tw:.3g}, float64's {e_64:.3g} "
            f"(tolerance {tol:.3g}, derived: {n_trunk} launches x K2_ATOL; the "
            f"twin's from float64 {e_tw64:.3g}); the tail ({n_tail} launches "
            f"and the attentions, logits spread by up to "
            f"{', '.join(f'{v:.4g}' for v in spreads)} in a row) from the "
            f"twin's trunk: mean distance from float64 K2 {m_k2:.4g}, the "
            f"twin {m_tw:.4g} (held at most {TAIL_F64_RATIO:g}x), max K2 "
            f"{float(d_k2.max()):.3g}, the twin {float(d_tw.max()):.3g}, max"
            f"|K2 - twin| {float((tail_k2 - tail_tw).abs().max()):.3g}; the "
            f"output from the image against the twin "
            f"{float((out - ref).abs().max()):.3g}, against float64 "
            f"{float((out.double() - o_64).abs().max()):.3g} (the twin's "
            f"{float((ref.double() - o_64).abs().max()):.3g})")


def phase_inference(s: InferenceSlice, dev, seed: int, sync, card: str) -> dict:
    """Patch and full-image SR through ``pipeline/inference.py`` at full
    width. Each path is driven once with the launch counts set to 0 just
    before it and read just after (no plain twin on the card), then again
    (bit for bit the same), on K2's plain twin (the reference), and with
    every K2 launch held against the twin on its own input. Returns the
    launches per path and K2's times at the paths' shapes."""
    from tpusr_torch.config import ESRGANConfig
    from tpusr_torch.models import EDSR, SRCNN
    from tpusr_torch.models.esrgan import ESRGANGenerator
    from tpusr_torch.pipeline.inference import (srcnn_super_resolve,
                                                super_resolve_full_image,
                                                super_resolve_image)

    def gen(k):
        return seed * 100 + k
    lr = (smooth_images(torch.Generator(device=dev).manual_seed(seed + 40), 1,
                        s.lr, 3, dev)[0] / 255.0).contiguous()
    hr = 4 * s.lr
    edsr = EDSR(scale_factor=4, device=dev, key=gen(1))
    srcnn = SRCNN(device=dev, key=gen(2))
    c8 = ESRGANConfig()
    esr8 = ESRGANGenerator(c8.scale_factor, c8.growth_channels,
                           c8.num_rrdb_blocks, device=dev, key=gen(3))
    esr32 = ESRGANGenerator(device=dev, key=gen(4))
    n8 = sum(p.numel() for p in esr8.parameters())
    check(n8 == 1_162_915, f"ESRGANConfig generator has {n8} parameters")
    # name: (call, K2 launches, output side, tolerance against the twin:
    # None = derived from K2's per-conv tolerance, the generator held in two
    # parts in place of its output, or None)
    paths = {
        "edsr_x4_patches": (lambda: super_resolve_image(
            edsr, lr, s.patch, s.stride, scale=4), 2 * 16 + 5, hr, SR_ATOL,
            None),
        "srcnn": (lambda: srcnn_super_resolve(
            srcnn, lr, hr, hr, s.srcnn_patch, s.srcnn_stride), 0, hr, None,
            None),
        "esrgan_g8x4_patches": (lambda: super_resolve_image(
            esr8, lr, s.patch, s.stride, scale=2, normalize_pm1=True),
            esrgan_launches(4, 2), 2 * s.lr, None, None),
        "esrgan_g8x4_full": (lambda: super_resolve_full_image(
            esr8, lr, attention_block_size=s.attention_block),
            esrgan_launches(4, 2), 2 * s.lr, None, None),
        "esrgan_g32x23_full": (lambda: super_resolve_full_image(
            esr32, lr, attention_block_size=s.attention_block),
            esrgan_launches(23, 2), 2 * s.lr, None, esr32),
    }
    launches, shapes = {}, {}
    for name, (call, want_k2, side, tol, in_parts) in paths.items():
        torch.cuda.reset_peak_memory_stats(dev)
        with count_plain_calls() as plain:
            reset_counts()
            out, m = call()
            got = read_counts()
        launches[name] = got["conv3x3_bias_act"]
        check(got == launches_want(conv3x3_bias_act=want_k2),
              f"{name}: launches {got} != {want_k2} K2")
        check(plain.n == 0, f"{name}: plain twins on the card {plain.by_twin}")
        out = torch.as_tensor(out, device=dev)
        check(tuple(out.shape) == (side, side, 3), f"{name}: {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()) and float(out.min()) >= 0.0
              and float(out.max()) <= 1.0, f"{name}: not finite in [0, 1]")
        torch.cuda.reset_peak_memory_stats(dev)
        again, m2 = call()
        check(torch.equal(torch.as_tensor(again, device=dev), out),
              f"{name}: a second call differs")
        line = (f"[inference] {name}: {tuple(out.shape)} in "
                f"[{float(out.min()):.3f}, {float(out.max()):.3f}], K2 "
                f"launches {launches[name]}, plain twins 0; time_sec "
                f"{m['time_sec']:.4f} (first call), {m2['time_sec']:.4f} "
                f"(second); gpu_peak_mb {m2['gpu_peak_mb']:.1f}, "
                f"gpu_mean_current_mb {m2['gpu_mean_current_mb']:.1f}")
        if want_k2:
            with models_on_k2_twin():
                ref = torch.as_tensor(call()[0], device=dev)
            with k2_against_twin() as k2c:
                call()
            check(len(k2c.rows) == want_k2, f"{name}: {len(k2c.rows)} checked")
            check(all(r[4] for r in k2c.rows),
                  f"{name}: K2 beyond the per-output bound against its twin "
                  f"at {[r[0] for r in k2c.rows if not r[4]]}")
            if tol is None:
                # K2's per-conv tolerance against its twin (K2_ATOL, held at
                # every serving shape) at each launch, carried to the output
                # to first order with gain 1 (tanh, the overlap mean and the
                # clip are 1-Lipschitz) and halved by the [-1, 1] -> [0, 1]
                # map
                tol = 0.5 * want_k2 * K2_ATOL
                how = f"derived: 1/2 x {want_k2} launches x K2_ATOL"
            else:
                how = "SR_ATOL, as the served f32 SR"
            err = float((out - ref).abs().max())
            if in_parts is None:
                check(err <= tol, f"{name}: against the twin max|err| {err} "
                                  f"> {tol}")
                line += (f"; against the same call on K2's twin max|err| "
                         f"{err:.3g} (tolerance {tol:.3g}, {how})")
            else:
                line += "; " + check_chaotic_generator(
                    in_parts, lr, s.attention_block, out, ref)
            line += (f"; every launch "
                     f"within its per-output bound against the twin on its "
                     f"own input (largest err {max(r[2] for r in k2c.rows):.3g}"
                     f", largest bound {max(r[3] for r in k2c.rows):.3g})")
            for shape, relu, *_ in k2c.rows:
                per = shapes.setdefault((shape, relu), {})
                per[name] = per.get(name, 0) + 1
        print(line)
        del out, again
        torch.cuda.empty_cache()

    times = k2_shape_times(shapes, dev)
    per_path = {}
    for (shape, relu), t in times.items():
        uses = shapes[(shape, relu)]
        print(f"[inference-K2] {str(shape):26s} relu={int(relu)} "
              f"{', '.join(f'{p} x{n}' for p, n in uses.items())}: kernel "
              f"{t['ms']:.4f} ms ({t['ops'] / t['ms'] / 1e9:.1f} TFLOP/s, "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of bound)  F.conv2d fp32 "
              f"{t['library_ms']:.4f} ms  twin {t['plain_ms']:.4f} ms  bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})  max|err| "
              f"{t['err']:.3g}" + ("  SLOWER than F.conv2d"
                                   if t["ms"] > t["library_ms"] else ""))
        for p, n in uses.items():
            tot = per_path.setdefault(p, {"ms": 0.0, "plain_ms": 0.0,
                                          "library_ms": 0.0, "bound_ms": 0.0,
                                          "err": 0.0, "t_ops": 0.0,
                                          "t_bytes": 0.0})
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] += n * t[key]
            tot["t_" + ("ops" if t["bound_by"] == "operations" else "bytes")] \
                += n * t["bound_ms"]
            tot["err"] = max(tot["err"], t["err"])
    for p, tot in per_path.items():
        print(f"[inference-K2] {card}: {p}: {launches[p]} launches, kernel "
              f"{tot['ms']:.3f} ms, F.conv2d fp32 {tot['library_ms']:.3f} ms, "
              f"bound {tot['bound_ms']:.3f} ms "
              f"({100 * tot['bound_ms'] / tot['ms']:.1f}%)")
    return {"launches": launches, "k2": per_path}


# ----------------------------------------------------------------- training

@dataclass(frozen=True)
class TrainSlice:
    """The trainers at the serving gate's shapes (tools/serving_gate.py
    ``train_edsr``: EDSR x4, 16 blocks, 64 filters, batch 16 of LR 32^2 ->
    HR 128^2, rate 1e-4; ``train_classifier``: VGG16, 2 classes, batch 64 of
    96^2, rate 2e-4, dropout on)."""
    lr: int = 32
    scale: int = 4
    blocks: int = 16
    filters: int = 64
    batch: int = 16
    edsr_steps: int = 20
    twin_steps: int = 3
    widths: tuple = (64, 128, 256, 512, 512)
    dense: int = 256
    vgg_batch: int = 64
    vgg_patch: int = 96
    vgg_steps: int = 10
    pool: int = 256
    fit_pairs: int = 64
    val_pairs: int = 16
    fit_epochs: int = 2


TRAIN_LOSS_RTOL = 1e-4   # 3 trainer steps on K2 against 3 on the twin
GRAD_RTOL = 1e-5         # dW, db: |d| <= 1e-5 max|g| (cuDNN on both sides)
FP32_UNIT = 2.0 ** -24


def edsr_train_layers(t: TrainSlice) -> list[tuple[str, tuple, bool]]:
    """(conv, forward shape (N, H, W, Cin, Cout), relu) of every conv of
    the x4 EDSR training forward, in order: 37 K2 launches; the backward
    launches K2 once more for each but the head (its input is the data)."""
    n, h, f = t.batch, t.lr, t.filters
    out = [("head", (n, h, h, 3, f), False)]
    for i in range(t.blocks):
        out += [(f"res{i}.conv1", (n, h, h, f, f), True),
                (f"res{i}.conv2", (n, h, h, f, f), False)]
    return out + [("body", (n, h, h, f, f), False),
                  ("up0", (n, h, h, f, 4 * f), False),
                  ("up1", (n, 2 * h, 2 * h, f, 4 * f), False),
                  ("tail", (n, 4 * h, 4 * h, f, 3), False)]


def k2_f32_bound(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The largest difference (float64, per output) of two fp32 results of
    the 3x3 SAME conv of ``x`` (N, H, W, C) with ``k`` (3, 3, C, Cout) that
    sum its K = 9*C products in any order: 2 * K * 2^-24 * S, S = the same
    conv on |x|, |k| in float64 (the second term of ``k2_bf16_tolerance``
    with fp32's unit). For dX, x is dY and k the flipped, transposed
    kernel, so C is the forward's Cout."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain
    zero = torch.zeros(k.shape[-1], dtype=torch.float64, device=x.device)
    s = conv3x3_bias_act_plain(x.double().abs(), k.double().abs(), zero)
    return 2 * 9 * x.shape[-1] * FP32_UNIT * s


PLAIN_TWINS = (("conv3x3", "conv3x3_bias_act_plain"),        # K2
               ("conv3x3", "conv3x3_int8_requant_plain"),    # K1
               ("conv3x3", "conv3x3_int8_dequant_plain"),    # the dequant conv
               ("block1", "block1_plain"),                   # K3
               ("prng", "_bits32"))      # K5: the words of every plain draw


class count_plain_calls:
    """Count the calls on the card (with a CUDA tensor argument, or for the
    draws' words a CUDA device) of the kernels' plain twins, made through
    their wrappers' modules while the context is open (``n``, by twin in
    ``by_twin``)."""

    def __enter__(self):
        from tpusr_torch.core import conv3x3, prng
        from tpusr_torch.models import block1
        mods = {"conv3x3": conv3x3, "block1": block1, "prng": prng}
        self.by_twin, self._saved = {}, []

        def on_card(v):
            return ((isinstance(v, torch.Tensor) and v.is_cuda)
                    or (isinstance(v, torch.device) and v.type == "cuda")
                    or (isinstance(v, str) and v.startswith("cuda")))

        def counted(name, orig):
            def call(*a, **kw):
                if any(on_card(v) for v in (*a, *kw.values())):
                    self.by_twin[name] = self.by_twin.get(name, 0) + 1
                return orig(*a, **kw)
            return call
        for mod, name in PLAIN_TWINS:
            orig = getattr(mods[mod], name)
            self._saved.append((mods[mod], name, orig))
            setattr(mods[mod], name, counted(name, orig))
        return self

    @property
    def n(self) -> int:
        return sum(self.by_twin.values())

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)


class train_on_plain_twin:
    """Route the EDSR training forward's convs to K2's plain twin under
    autograd (``F.conv2d`` + bias + ReLU; cuDNN's backward) for the
    duration of a reference computation."""

    def __enter__(self):
        from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain
        from tpusr_torch.models import edsr
        self._mod, self._orig = edsr, edsr.conv3x3_bias_act_train
        edsr.conv3x3_bias_act_train = (
            lambda x, k, b, relu=False: conv3x3_bias_act_plain(x, k, b, relu))

    def __exit__(self, *exc):
        self._mod.conv3x3_bias_act_train = self._orig


def k2_backward_case(name: str, x: torch.Tensor, dy: torch.Tensor,
                     kernel: torch.Tensor, bias: torch.Tensor, relu: bool,
                     need_dx: bool, worst: dict) -> None:
    """One conv of a training backward: the K2 Function's gradients on
    ``x`` and the output gradient ``dy`` against autograd through the plain
    twin on the same inputs (``dy`` masked by K2's ReLU output on both
    sides; the masks of K2's and the twin's outputs may differ only where
    the twin's pre-activation is within K2_ATOL of 0). dX is held to
    ``k2_f32_bound``, dW and db to ``GRAD_RTOL`` of their largest value;
    ``worst`` collects the largest shares."""
    from tpusr_torch.core.conv3x3 import (conv3x3_bias_act_plain,
                                          conv3x3_bias_act_train)
    shape = (*x.shape, kernel.shape[-1])
    xa = x.clone().requires_grad_(need_dx)
    ka, ba = (p.detach().clone().requires_grad_() for p in (kernel, bias))
    y = conv3x3_bias_act_train(xa, ka, ba, relu)
    y.backward(dy)
    xb = x.clone().requires_grad_(need_dx)
    kb, bb = (p.detach().clone().requires_grad_() for p in (kernel, bias))
    pre = conv3x3_bias_act_plain(xb, kb, bb, False)
    g_ref = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    pre.backward(g_ref)
    torch.cuda.synchronize()
    if relu:
        flips = (y > 0) != (pre > 0)
        n_flip = int(flips.sum())
        check(n_flip == 0
              or float(pre.detach()[flips].abs().max()) <= K2_ATOL,
              f"{name}: K2's and the twin's ReLU masks differ away from 0")
        worst["flips"] += n_flip
    if need_dx:
        k_t = kernel.detach().flip(0, 1).transpose(2, 3).contiguous()
        tol = k2_f32_bound(g_ref, k_t)
        d = (xa.grad.double() - xb.grad.double()).abs()
        n_out = int((d > tol).sum())
        check(n_out == 0, f"{name}: dX of the K2 Function vs the twin "
                          f"at {shape}: {n_out} values beyond the bound "
                          f"(max |d| {float(d.max()):.3g})")
        worst["dx_share"] = max(worst["dx_share"], float((d / tol).max()))
        worst["dx_err"] = max(worst["dx_err"], float(d.max()))
    for key, ga, gb in (("dw", ka.grad, kb.grad), ("db", ba.grad, bb.grad)):
        err = float((ga - gb).abs().max())
        scale = float(gb.abs().max())
        check(err <= GRAD_RTOL * scale, f"{name}: {key} of the K2 Function"
              f" vs the twin: max|d| {err:.3g} > {GRAD_RTOL} x {scale:.3g}")
        worst[key] = max(worst[key], err / scale if scale else 0.0)


def new_worst() -> dict:
    return {"dx_share": 0.0, "dw": 0.0, "db": 0.0, "flips": 0, "dx_err": 0.0}


def check_k2_backward(t: TrainSlice, edsr, dev) -> dict:
    """``k2_backward_case`` at every conv of the EDSR training forward, on
    the model's weights, random x and a random dY."""
    g = torch.Generator(device=dev).manual_seed(5)
    worst = new_worst()
    convs = dict(edsr.named_modules())
    for name, shape, relu in edsr_train_layers(t):
        n, h, w, cin, cout = shape
        m = convs[name]
        x = torch.randn((n, h, w, cin), generator=g, device=dev)
        dy = torch.randn((n, h, w, cout), generator=g, device=dev)
        k2_backward_case(name, x, dy, m.kernel, m.bias, relu,
                         name != "head", worst)
        del x, dy
    torch.cuda.empty_cache()
    n_fwd = len(edsr_train_layers(t))
    print(f"[train] K2 Function vs autograd through the twin at the {n_fwd} "
          f"convs ({n_fwd - 1} dX shapes, Cin {4 * t.filters} at up0/up1, Cin 3"
          f" at the tail): dX within "
          f"2*9*C*2^-24*sum|dY||k| everywhere (largest share of the bound "
          f"{worst['dx_share']:.3f}, max|d| {worst['dx_err']:.3g}); dW, db "
          f"within {GRAD_RTOL} of their max (worst {worst['dw']:.2g}, "
          f"{worst['db']:.2g}); ReLU masks differ at {worst['flips']} "
          f"near-zero outputs")
    return worst


def trace_records(events: list, lead_name: str) -> dict:
    """What a ``profiling.trace`` Chrome trace kept of its launches: the
    kernel launches made on the host inside the lead span ``lead_name``
    (``lead``) and after it (``block``), and how many of each have no
    kernel record of the same correlation id (``lead_lost``,
    ``block_lost``)."""
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == lead_name)
    end = span["ts"] + span["dur"]
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel"}
    lead, block = set(), set()
    for e in events:
        if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", ""):
            (lead if span["ts"] <= e["ts"] <= end else
             block if e["ts"] > end else set()).add(e["args"]["correlation"])
    return {"lead": len(lead), "lead_lost": len(lead - kernels),
            "block": len(block), "block_lost": len(block - kernels)}


class k2_train_io:
    """While open, record each K2 training conv of the models
    (``edsr.conv3x3_bias_act_train``: EDSR's and ESRGAN's) in call order:
    ``calls`` holds [x, kernel, bias, relu, dY], dY being the gradient that
    reaches the conv's output in the backward."""

    def __enter__(self):
        from tpusr_torch.models import edsr
        self.calls = []

        def wrap(orig):
            def call(x, k, b, relu=False):
                y = orig(x, k, b, relu)
                row = [x.detach().clone(), k.detach(), b.detach(), relu, None]
                self.calls.append(row)
                y.register_hook(lambda g, row=row: row.__setitem__(
                    4, g.detach().clone()))
                return y
            return call
        self._p = patched(edsr, conv3x3_bias_act_train=wrap)
        self._p.__enter__()
        return self

    def __exit__(self, *exc):
        self._p.__exit__(*exc)


def recorded_backward_cases(tag: str, layers: list, calls: list) -> dict:
    """``k2_backward_case`` at each conv of ``layers`` ((name, shape, relu)
    in forward order) on the x, weights and dY that ``k2_train_io``
    recorded (``calls``), which must be those convs; returns the worst
    shares (``new_worst``)."""
    want = [(shape, relu) for _, shape, relu in layers]
    check([((*c[0].shape, c[1].shape[-1]), c[3]) for c in calls] == want
          and all(c[4] is not None for c in calls),
          f"{tag}: the training forward's convs are not {want}")
    worst = new_worst()
    for (name, _, relu), (x, kernel, bias, _, dy) in zip(layers, calls):
        k2_backward_case(f"{tag} {name}", x, dy, kernel, bias, relu,
                         name != layers[0][0], worst)
    return worst


def train_k2_times(layers: list, convs: dict, dev, card: str,
                   tag: str = "train-K2", what: str = "EDSR train step",
                   dtype: torch.dtype = torch.float32) -> dict:
    """K2's ms per train step at the training shapes ``layers`` ((name,
    shape, relu) in forward order; the first conv's input is the data, so
    it has no dX launch): the forward and the dX launches in ``dtype``,
    beside the plain twin, ``F.conv2d`` (forward) and
    ``torch.nn.grad.conv2d_input`` (dX) in the same dtype at the same
    shapes, and the bound (``conv_work``: fp32 operations, or bf16 by its
    bytes where they take longer). ``convs`` maps a name to its conv
    module (its kernel and bias)."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
    bf16 = dtype == torch.bfloat16
    elem, kind = (2, "bf16") if bf16 else (4, "fp32")
    g = torch.Generator(device=dev).manual_seed(6)
    first = layers[0][0]
    distinct = {}
    for name, shape, relu in layers:   # distinct (shape, relu, first)
        key = (shape, relu, name == first)
        distinct.setdefault(key, [name, 0])[1] += 1
    tot = {k: 0.0 for k in ("fwd_ms", "dx_ms", "plain_ms", "library_ms",
                            "bound_ms", "t_ops", "t_bytes")}
    for (shape, relu, is_first), (name, mult) in distinct.items():
        n, h, w, cin, cout = shape
        m = convs[name]
        k = m.kernel.detach().to(dtype)
        b = m.bias.detach().to(dtype).float()
        x = torch.randn((n, h, w, cin), generator=g, device=dev).to(dtype)
        dy = torch.randn((n, h, w, cout), generator=g, device=dev).to(dtype)
        k_t = k.flip(0, 1).transpose(2, 3).contiguous()
        zero = torch.zeros(cin, device=dev)
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        k_oihw = k.permute(3, 2, 0, 1).contiguous()
        b_lib = b.to(dtype)
        fwd = time_ms(lambda: conv3x3_bias_act(x, k, b, relu))
        lib = time_ms(lambda: F.conv2d(x_nchw, k_oihw, b_lib, padding=1))
        plain = time_ms(lambda: conv3x3_bias_act_plain(x, k, b, relu))
        ops, nbytes = conv_work(shape, elem, n_vecs=1)
        bms, by = bound(ops, nbytes, kind)
        line = (f"[{tag}] {name:22s} {str(shape):26s} relu={int(relu)} x{mult}"
                f"  forward {fwd:.4f} ms ({ops / fwd / 1e9:.1f} TFLOP/s)  "
                f"F.conv2d {lib:.4f}  twin {plain:.4f}  bound {bms:.4f} ({by})")
        tot["fwd_ms"] += mult * fwd
        tot["library_ms"] += mult * lib
        tot["plain_ms"] += mult * plain
        tot["bound_ms"] += mult * bms
        tot["t_" + ("ops" if by == "operations" else by)] += mult * bms
        if not is_first:
            dx = time_ms(lambda: conv3x3_bias_act(dy, k_t, zero))
            dlib = time_ms(lambda: torch.nn.grad.conv2d_input(
                x_nchw.shape, k_oihw, dy_nchw, padding=1))
            dplain = time_ms(lambda: conv3x3_bias_act_plain(dy, k_t, zero))
            ops, nbytes = conv_work((n, h, w, cout, cin), elem, n_vecs=1)
            dbms, dby = bound(ops, nbytes, kind)
            line += (f";  dX {dx:.4f} ms ({ops / dx / 1e9:.1f} TFLOP/s)  "
                     f"conv2d_input {dlib:.4f}  twin {dplain:.4f}  bound "
                     f"{dbms:.4f} ({dby})")
            tot["dx_ms"] += mult * dx
            tot["library_ms"] += mult * dlib
            tot["plain_ms"] += mult * dplain
            tot["bound_ms"] += mult * dbms
            tot["t_" + ("ops" if dby == "operations" else dby)] += mult * dbms
        print(line)
        del x, dy
    torch.cuda.empty_cache()
    tot["ms"] = tot["fwd_ms"] + tot["dx_ms"]
    n_fwd = len(layers)
    print(f"[{tag}] {card}: per {what}: {n_fwd} forward launches "
          f"{tot['fwd_ms']:.3f} ms + {n_fwd - 1} dX launches "
          f"{tot['dx_ms']:.3f} ms = "
          f"{tot['ms']:.3f} ms; F.conv2d + conv2d_input {kind} "
          f"{tot['library_ms']:.3f} ms; twin {tot['plain_ms']:.3f} ms; bound "
          f"{tot['bound_ms']:.3f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f}%)")
    return tot


def sr_pairs(g: torch.Generator, n: int, t: TrainSlice, dev):
    """(LR, HR) pairs from ``smooth_images``: HR crops in [0, 1] at the
    gate's 128^2 (lr * scale), LR their area downscale, as train_edsr
    makes them."""
    from tpusr_torch.core.resize import resize
    hr = smooth_images(g, n, t.lr * t.scale, 3, dev) / 255.0
    return resize(hr, (t.lr, t.lr), "area"), hr


def timed_steps(step, n: int):
    """Run ``step(i)`` for i < n; returns the results and the device ms of
    each step by CUDA events around it."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    out = []
    for i in range(n):
        starts[i].record()
        out.append(step(i))
        ends[i].record()
    torch.cuda.synchronize()
    return out, [s.elapsed_time(e) for s, e in zip(starts, ends)]


def kernel_group(name: str) -> str:
    """The group a device kernel's time is booked under in a train step."""
    low = name.lower()
    if "conv3x3" in low:
        return "K2"
    if "prng_kernel" in low:
        return "K5"
    if any(w in low for w in ("cudnn", "xmma", "cutlass", "gemm", "conv",
                              "wgrad", "dgrad", "fprop")):
        return "cuDNN/cuBLAS"
    if "multi_tensor" in low or "foreach" in low:
        return "foreach (Adam)"
    if "reduce" in low:
        return "reductions"
    return "elementwise/other"


def step_profile(step, n: int = 3) -> dict:
    """Per call of ``step()``, from a ``torch.profiler`` trace of ``n`` calls
    after a warm-up: device ms by kernel group (empty when the trace holds
    no device events), kernel launches, the six kernels and the five host
    ops that take most time, as (name, ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpusr_torch.train.profiling import TRACE_MARGIN_S
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the margins of profiling.trace: no kernel record falls outside
        time.sleep(TRACE_MARGIN_S)
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    groups: dict[str, float] = {}
    for e in kernels:
        key = kernel_group(e.key)
        groups[key] = groups.get(key, 0.0) + e.self_device_time_total / 1e3 / n

    def top(evs, attr, k):
        evs = sorted(evs, key=lambda e: -getattr(e, attr))[:k]
        return [(e.key[:48], getattr(e, attr) / 1e3 / n, e.count / n) for e in evs]
    return {"groups": groups, "launches": sum(e.count for e in kernels) / n,
            "kernels": top(kernels, "self_device_time_total", 6),
            "host": top(host, "self_cpu_time_total", 5)}


def print_breakdown(tag: str, card: str, step, step_ms: float) -> None:
    prof = step_profile(step)
    groups, busy = prof["groups"], sum(prof["groups"].values())
    if not groups:
        print(f"[train] {tag}: the profiler trace holds no device events; "
              f"device busy time not measured")
        return

    def listed(rows):
        return "; ".join(f"{nm} {ms:.3f} ms x{c:g}" for nm, ms, c in rows)
    print(f"[train] {card}: {tag} step, device busy {busy:.3f} ms of "
          f"{step_ms:.3f} (idle share {100 * (1 - busy / step_ms):.1f}%, "
          f"torch.profiler, 3 steps), {prof['launches']:g} kernel launches: "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
          + f"; top kernels {listed(prof['kernels'])}; top host ops (self "
          f"CPU) {listed(prof['host'])}")


def phase_train(t: TrainSlice, dev, seed: int, sync, card: str) -> dict:
    """The training path on the card: K2's backward against its twin, three
    trainer steps on K2 against three on the twin, then the main path (20
    EDSR x4 steps and one eval step, 10 VGG16 steps, a 2-epoch fit with
    periodic checkpoints, restored and evaluated) with its launch counts and
    no call of K2's plain twin; and K2's times at the training shapes."""
    import tempfile

    from tpusr_torch.core import conv3x3
    from tpusr_torch.models import EDSR, VGG16Classifier
    from tpusr_torch.train import (ClassifierTrainer, SupervisedSRTrainer,
                                   restore_checkpoint)

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    pool_lr, pool_hr = sr_pairs(g, t.pool, t, dev)
    clf_x = smooth_images(g, t.pool, t.vgg_patch, 3, dev) / 255.0
    bright = clf_x.mean(dim=(1, 2, 3))
    clf_y = (bright > bright.median()).to(torch.int32)
    sel = torch.randint(0, t.pool, (t.edsr_steps, t.batch), generator=g,
                        device=dev)
    clf_sel = torch.randint(0, t.pool, (t.vgg_steps, t.vgg_batch), generator=g,
                            device=dev)
    edsr = EDSR(scale_factor=t.scale, num_res_blocks=t.blocks,
                num_filters=t.filters, device=dev,
                key=seed)
    trainer = SupervisedSRTrainer(edsr, learning_rate=1e-4, device=dev)
    sync()
    print(f"[train] EDSR x{t.scale} {t.blocks} blocks {t.filters} filters, "
          f"batch {t.batch} of LR {t.lr}^2 -> HR {t.lr * t.scale}^2, rate 1e-4;"
          f" VGG16 widths {t.widths}, batch {t.vgg_batch} of {t.vgg_patch}^2, "
          f"rate 2e-4, dropout 0.2; seed {seed}; set-up "
          f"{time.perf_counter() - t0:.1f} s")

    back = check_k2_backward(t, edsr, dev)

    # ---- three trainer steps on K2 against three on the twin ----
    def steps_from(state, n):
        losses = []
        for i in range(n):
            state, m = trainer.train_step(state, pool_lr[sel[i]], pool_hr[sel[i]])
            losses.append(float(m["loss"]))
        return losses
    on_k2 = steps_from(trainer.init_state(), t.twin_steps)
    with train_on_plain_twin():
        on_twin = steps_from(trainer.init_state(), t.twin_steps)
    rel = max(abs(a - b) / abs(b) for a, b in zip(on_k2, on_twin))
    print(f"[train] {t.twin_steps} EDSR steps on K2 vs on the twin: losses "
          f"{[f'{v:.6f}' for v in on_k2]} vs {[f'{v:.6f}' for v in on_twin]} "
          f"(max rel {rel:.2g}, rtol {TRAIN_LOSS_RTOL})")
    check(rel <= TRAIN_LOSS_RTOL, f"trainer on K2 vs on the twin: {rel}")

    # ---- the main path ----
    n_fwd = len(edsr_train_layers(t))
    per_step = launches_want(conv3x3_bias_act=2 * n_fwd - 1)
    per_eval = launches_want(conv3x3_bias_act=n_fwd)
    counted = {}
    with count_plain_calls() as plain:
        torch.cuda.reset_peak_memory_stats(dev)
        state = trainer.init_state()
        reset_counts()

        def edsr_step(i):
            nonlocal state
            before = read_counts()
            state, m = trainer.train_step(state, pool_lr[sel[i]], pool_hr[sel[i]])
            after = read_counts()
            check({k: after[k] - before[k] for k in after} == per_step,
                  f"EDSR train step {i}: launches {after} - {before} != "
                  f"{per_step}")
            return m["loss"]
        losses, edsr_ms = timed_steps(edsr_step, t.edsr_steps)
        before = read_counts()
        ev = trainer.eval_step(state, pool_lr[:t.batch], pool_hr[:t.batch])
        after = read_counts()
        check({k: after[k] - before[k] for k in after} == per_eval,
              f"EDSR eval step: launches {after} - {before} != {per_eval}")
        edsr_peak = torch.cuda.max_memory_allocated(dev)
        counted["edsr"] = read_counts()["conv3x3_bias_act"]
        losses = [float(v) for v in losses]
        check(all(math.isfinite(v) for v in losses), f"EDSR losses {losses}")
        late = float(np.mean(losses[-5:]))
        check(late < losses[0], f"EDSR loss did not fall: first {losses[0]}, "
                                f"mean of the last 5 {late}")
        check(all(math.isfinite(float(ev[k])) for k in ("loss", "psnr", "ssim")),
              f"EDSR eval {ev}")
        edsr_med = float(np.median(edsr_ms))
        print_breakdown("EDSR x4 train", card, lambda: trainer.train_step(
            state, pool_lr[sel[0]], pool_hr[sel[0]]), edsr_med)
        del state
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats(dev)
        vgg = VGG16Classifier(num_classes=2, dense_units=t.dense,
                              widths=t.widths, device=dev,
                              key=seed + 1)
        clf = ClassifierTrainer(vgg, learning_rate=2e-4, device=dev)
        cstate = clf.init_state()
        reset_counts()

        def vgg_step(i):
            nonlocal cstate
            cstate, m = clf.train_step(cstate, clf_x[clf_sel[i]],
                                       clf_y[clf_sel[i]], i)
            return m["loss"], m["accuracy"]
        vgg_out, vgg_ms = timed_steps(vgg_step, t.vgg_steps)
        vgg_peak = torch.cuda.max_memory_allocated(dev)
        # each step draws its two dropout masks on K5
        check(read_counts() == launches_want(prng=2 * t.vgg_steps),
              f"VGG16 steps launched {read_counts()}")
        K5_BY_PATH["train"] = k5_launches()
        vgg_losses = [float(l) for l, _ in vgg_out]
        check(all(math.isfinite(v) for v in vgg_losses), f"VGG losses {vgg_losses}")
        vgg_med = float(np.median(vgg_ms))
        print_breakdown("VGG16 train", card, lambda: clf.train_step(
            cstate, clf_x[clf_sel[0]], clf_y[clf_sel[0]], 0), vgg_med)
        del cstate, clf, vgg
        torch.cuda.empty_cache()

        # a 2-epoch fit with a checkpoint each epoch, restored and evaluated
        fit_lr, fit_hr = pool_lr[:t.fit_pairs], pool_hr[:t.fit_pairs]
        val_lr = pool_lr[t.fit_pairs:t.fit_pairs + t.val_pairs]
        val_hr = pool_hr[t.fit_pairs:t.fit_pairs + t.val_pairs]
        n_train = math.ceil(t.fit_pairs / t.batch)
        n_val = math.ceil(t.val_pairs / t.batch)
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            res = trainer.fit(fit_lr, fit_hr, val_lr, val_hr,
                              batch_size=t.batch, epochs=t.fit_epochs,
                              verbose=False, checkpoint_dir=tmp,
                              checkpoint_every=1)
            n_ep = len(res.history["loss"])
            want = launches_want(conv3x3_bias_act=n_ep * (
                n_train * (2 * n_fwd - 1) + n_val * n_fwd))
            check(read_counts() == want, f"fit launched {read_counts()}, "
                                         f"expected {want}")
            counted["fit"] = read_counts()["conv3x3_bias_act"]
            saved = sorted(f for f in os.listdir(tmp) if not f.endswith(".json"))
            check(saved == [f"epoch_{e + 1:04d}" for e in range(n_ep)],
                  f"checkpoints {saved}")
            last = saved[-1]
            restored = restore_checkpoint(tmp, last, trainer.init_state())
            check(restored.opt_state["count"] == n_ep * n_train,
                  f"restored Adam count {restored.opt_state['count']}")
            reset_counts()
            evr = trainer.evaluate(restored, val_lr, val_hr, batch_size=t.batch)
            check(read_counts() == launches_want(conv3x3_bias_act=n_val * n_fwd),
                  f"evaluate launched {read_counts()}")
            counted["evaluate"] = read_counts()["conv3x3_bias_act"]
            check(abs(evr["loss"] - res.history["val_loss"][-1])
                  <= 1e-6 * abs(res.history["val_loss"][-1]),
                  f"restored {last}: val loss {evr['loss']} != the fit's "
                  f"{res.history['val_loss'][-1]}")
    check(plain.n == 0, f"plain twins were called on the card's training path: "
                        f"{plain.by_twin}")
    print(f"[train] {card}: EDSR x{t.scale} train step median {edsr_med:.3f} ms"
          f" (CUDA events, {t.edsr_steps} steps, first {edsr_ms[0]:.1f} ms), "
          f"{2 * n_fwd - 1} K2 launches a step ({n_fwd} forward + {n_fwd - 1} "
          f"dX), {n_fwd} an eval step; peak memory {edsr_peak / 1e9:.2f} GB; "
          f"loss {losses[0]:.5f} -> mean of the last 5 {late:.5f}; eval PSNR "
          f"{float(ev['psnr']):.2f} dB, SSIM {float(ev['ssim']):.4f}; plain "
          f"twins called {plain.n} times on the card")
    print(f"[train] {card}: VGG16 train step median {vgg_med:.3f} ms (CUDA "
          f"events, {t.vgg_steps} steps of {t.vgg_batch}, first "
          f"{vgg_ms[0]:.1f} ms); peak memory {vgg_peak / 1e9:.2f} GB; losses "
          f"{[round(v, 4) for v in vgg_losses]}")
    print(f"[train] {card}: fit {n_ep} epochs of {t.fit_pairs} pairs at batch "
          f"{t.batch}: epoch times "
          f"{[round(v, 3) for v in res.time_tracker.epoch_times_sec]} s, peak "
          f"{res.memory_tracker.as_dict()['gpu_peak_mb']:.0f} MB, val loss "
          f"{[round(v, 6) for v in res.history['val_loss']]}; checkpoints "
          f"{saved}; {last} restored: count {restored.opt_state['count']}, "
          f"evaluate loss {evr['loss']:.6f} PSNR {evr['psnr']:.2f}")

    tot = train_k2_times(edsr_train_layers(t), dict(edsr.named_modules()),
                         dev, card)
    tot.update(launches=sum(counted.values()), err=back["dx_err"],
               edsr_step_ms=edsr_med, vgg_step_ms=vgg_med)
    return tot


# --------------------------------------------------------------------- GAN

@dataclass(frozen=True)
class GanSlice:
    """The adversarial ESRGAN trainer (``train/gan.py``) at ``ESRGANConfig``
    (growth 8, 4 RRDB, x2; the notebook's), batch 16 of LR 24^2 -> HR 48^2
    (the ``ESRGAN`` facade's input and output shapes), the full VGG19 to
    ``block5_conv4``, the trainer's rates; then a few steps at the facade's
    default width (growth 32, 23 RRDB)."""
    lr: int = 24
    scale: int = 2
    growth: int = 8
    rrdb: int = 4
    batch: int = 16
    twin_steps: int = 3
    steps: int = 20
    remat_steps: int = 3
    bf16_steps: int = 3
    wide_growth: int = 32
    wide_rrdb: int = 23
    wide_steps: int = 3
    pool: int = 128
    fit_pairs: int = 64
    val_pairs: int = 20
    fit_epochs: int = 2


def gan_train_layers(s: GanSlice, growth: int, rrdb: int,
                     f: int = 64) -> list[tuple[str, tuple, bool]]:
    """(conv, forward shape (N, H, W, Cin, Cout), relu) of every 3x3 conv of
    the ESRGAN generator's forward, in order: ``esrgan_launches`` K2
    launches; the backward launches K2 once more for each but the initial
    conv (its input is the data)."""
    n, h = s.batch, s.lr
    out = [("initial_conv", (n, h, h, 3, f), False)]
    for r in range(rrdb):
        for d in (1, 2, 3):
            out += [(f"rrdb_{r}.dense{d}.conv{i + 1}",
                     (n, h, h, f + i * growth, growth), True) for i in range(4)]
            out.append((f"rrdb_{r}.dense{d}.conv5",
                        (n, h, h, f + 4 * growth, f), False))
    out.append(("trunk_conv", (n, h, h, f, f), False))
    for u in range(int(math.log2(s.scale))):
        out.append((f"upsample_{u}_conv", (n, h, h, f, 4 * f), False))
        h *= 2
    return out + [("final_conv1", (n, h, h, f, f), True),
                  ("final_conv2", (n, h, h, f, 3), False)]


class dx_against_twin:
    """While open, every dX launch of K2-bf16's autograd Function (a call of
    ``conv3x3_bias_act`` inside ``Conv3x3BiasActFn.backward`` on bf16) also
    runs the plain twin on the same input, held to ``k2_bf16_tolerance``.
    ``n`` counts the launches held, ``err`` the largest |K2 - twin|."""

    def __enter__(self):
        from tpusr_torch.core import conv3x3
        from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain
        fn = conv3x3.Conv3x3BiasActFn
        self._fn, self._bwd = fn, fn.__dict__["backward"]
        self._mod, self._k2 = conv3x3, conv3x3.conv3x3_bias_act
        self.n, self.err = 0, 0.0
        in_bwd = [False]

        def k2(x, k, b, relu=False):
            y = self._k2(x, k, b, relu)
            if in_bwd[0]:
                check(x.dtype == torch.bfloat16, f"dX in {x.dtype}")
                _ulps, _over, err = check_k2_bf16(
                    x, k, y, conv3x3_bias_act_plain(x, k, b, relu))
                self.n += 1
                self.err = max(self.err, err)
            return y

        def backward(ctx, dy):
            in_bwd[0] = True
            try:
                return self._bwd.__func__(ctx, dy)
            finally:
                in_bwd[0] = False
        conv3x3.conv3x3_bias_act = k2
        fn.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self._mod.conv3x3_bias_act = self._k2
        self._fn.backward = self._bwd


def g_grads_f64(trainer, state, lr: torch.Tensor, hr: torch.Tensor):
    """A float64 witness of the G loss and its gradients: the loss terms of
    ``ESRGANTrainer._g_terms`` (restated here) with every weight, input
    and operation in float64 (the FFT in complex128) and the generator's
    convs on the plain twin (``F.conv2d`` in float64)."""
    from torch.func import functional_call
    from tpusr_torch.models.vgg import preprocess_caffe
    from tpusr_torch.train import gan
    f64 = torch.float64
    gp = {k: v.detach().to(f64).requires_grad_()
          for k, v in state.g_params.items()}
    dv = {k: v.detach().to(f64)
          for k, v in {**state.d_params, **state.d_spectral}.items()}
    vp = {k: v.detach().to(f64) for k, v in trainer.vgg_params.items()}
    hr = hr.to(f64)

    def mag(x):
        return torch.fft.fft2(x.to(torch.complex128), dim=(-2, -1)).abs()

    def feats(x):
        return functional_call(trainer.vgg_features, vp,
                               (preprocess_caffe((x + 1.0) * 127.5),))
    with torch.enable_grad(), train_on_plain_twin():
        fake = functional_call(trainer.generator, gp, (lr.to(f64),))
        d_fake = functional_call(trainer.discriminator, dv, (fake,))
        wa, wp, wx, ws = trainer.weights
        total = (wa * gan._bce(torch.ones_like(d_fake), d_fake)
                 + wp * torch.mean((feats(hr) - feats(fake)) ** 2)
                 + wx * torch.mean(torch.abs(hr - fake))
                 + ws * torch.mean(torch.abs(mag(hr) - mag(fake))))
        grads = torch.autograd.grad(total, list(gp.values()))
    return float(total), dict(zip(gp, grads))


def gan_grad_close(got: dict, want: dict, witness: dict) -> dict:
    """Per leaf of the G gradients: K2's (``got``) against the twin's
    (``want``) as a share of GRAD_RTOL x the leaf's max|g|, and each one's
    distance from the float64 witness as a share of the same scale. The
    attention's key bias (``.f.bias``), whose gradient is 0 in exact
    arithmetic (softmax is invariant to a shift shared by every key), is
    scaled by its layer's kernel gradient."""
    rows = {}
    for name, w in witness.items():
        scale = float(w.abs().max())
        if name.endswith(".f.bias"):
            scale = float(witness[name[:-4] + "kernel"].abs().max())
        unit = GRAD_RTOL * scale
        rows[name] = (float((got[name].double() - want[name].double())
                            .abs().max()) / unit,
                      float((got[name].double() - w).abs().max()) / unit,
                      float((want[name].double() - w).abs().max()) / unit)
    return rows


def phase_gan(s: GanSlice, dev, seed: int, sync, card: str) -> dict:
    """The adversarial ESRGAN trainer on the card: the G step's gradients
    and three steps on K2 against the twin (every dX launch within its
    bound); the main path (20 steps, launches per step, step times, device
    busy share, peak memory; the ``ESRGAN`` facade's 2-epoch fit, evaluate,
    save and ``from_trained``, byte-equal SR; a 2-epoch trainer fit with a
    checkpoint each epoch, restored) with no call of a plain twin; remat;
    bf16 training on K2-bf16; the facade's default width; K2's times at
    the training shapes. Returns K2's and K2-bf16's records."""
    import shutil
    import tempfile

    from tpusr_torch.models.init import drawn_leaves
    from tpusr_torch.models import (ESRGANDiscriminator, ESRGANGenerator,
                                    VGG19Features)
    from tpusr_torch.models.api import ESRGAN
    from tpusr_torch.train import ESRGANTrainer, restore_checkpoint
    from tpusr_torch.train.profiling import (TRACE_LEAD_KERNELS,
                                             TRACE_LEAD_NAME,
                                             device_memory_mb,
                                             time_compiled, trace)

    def gen(k):
        return seed * 100 + 60 + k
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 60)
    pool_lr, pool_hr = sr_pairs(g, s.pool, s, dev)
    pool_lr, pool_hr = pool_lr * 2.0 - 1.0, pool_hr * 2.0 - 1.0   # [-1, 1]
    sel = torch.randint(0, s.pool, (s.steps, s.batch), generator=g, device=dev)
    gen8 = ESRGANGenerator(s.scale, s.growth, s.rrdb, device=dev,
                           key=gen(1))
    disc = ESRGANDiscriminator(device=dev, key=gen(2))
    vgg = VGG19Features(device=dev, key=gen(3))
    trainer = ESRGANTrainer(gen8, disc, vgg, device=dev)
    layers = gan_train_layers(s, s.growth, s.rrdb)
    n_fwd = len(layers)
    check(n_fwd == esrgan_launches(s.rrdb, s.scale), f"{n_fwd} convs")
    per_step = launches_want(conv3x3_bias_act=2 * n_fwd - 1)

    def batch(i):
        return pool_lr[sel[i]], pool_hr[sel[i]]
    sync()
    print(f"[gan] ESRGAN generator growth {s.growth}, {s.rrdb} RRDB, x{s.scale};"
          f" spectral-norm discriminator; VGG19 to block5_conv4; batch "
          f"{s.batch} of LR {s.lr}^2 -> HR {s.lr * s.scale}^2; G 1e-4, D 1e-5;"
          f" seed {seed}; set-up {time.perf_counter() - t0:.1f} s")

    # ---- the G step on K2 against the twin ----
    def g_grads(state, lr, hr):
        with torch.enable_grad():
            total, _ = trainer.g_loss_components(
                state.g_params, state.d_params, state.d_spectral, lr, hr)
            grads = torch.autograd.grad(total, list(state.g_params.values()))
        return total.item(), dict(zip(state.g_params, grads))
    st0 = trainer.init_state()
    with k2_train_io() as rec:
        loss_k2, grads_k2 = g_grads(st0, *batch(0))
    # every conv of the step on its own recorded input and output gradient
    worst = recorded_backward_cases("G step", layers, rec.calls)
    del rec
    # end to end: the whole G gradient on the twin and in float64
    with train_on_plain_twin():
        loss_tw, grads_tw = g_grads(st0, *batch(0))
    loss_64, grads_64 = g_grads_f64(trainer, st0, *batch(0))
    check(abs(loss_k2 - loss_tw) <= TRAIN_LOSS_RTOL * abs(loss_tw),
          f"G loss on K2 {loss_k2} vs the twin {loss_tw}")
    rows = gan_grad_close(grads_k2, grads_tw, grads_64)
    over = sorted((r for r in rows.items() if r[1][0] > 1.0),
                  key=lambda kv: -kv[1][0])
    del grads_k2, grads_tw, grads_64

    def steps_from(tr, state, n, start=0):
        out = []
        for i in range(n):
            state, m = tr.train_step(state, *batch(start + i))
            out.append({k: float(v) for k, v in m.items()})
        return state, out
    _, on_k2 = steps_from(trainer, trainer.init_state(), s.twin_steps)
    with train_on_plain_twin():
        _, on_twin = steps_from(trainer, trainer.init_state(), s.twin_steps)
    rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(on_k2, on_twin)
              for k in ("g_loss", "d_loss"))
    check(rel <= TRAIN_LOSS_RTOL, f"GAN steps on K2 vs on the twin: {rel}")
    print(f"[gan] G step on K2 vs on the twin, at each of the {n_fwd} convs "
          f"on its recorded x and dY: the {n_fwd - 1} dX within "
          f"2*9*C*2^-24*sum|dY||k| (largest share {worst['dx_share']:.3f}, "
          f"max|d| {worst['dx_err']:.3g}), dW and db within {GRAD_RTOL} of their "
          f"max (worst {worst['dw']:.2g}, {worst['db']:.2g}), ReLU masks "
          f"differ at {worst['flips']} near-zero outputs; G loss K2 "
          f"{loss_k2:.7f}, twin {loss_tw:.7f}, float64 {loss_64:.7f}; "
          f"{s.twin_steps} steps: g_loss "
          f"{[round(m['g_loss'], 5) for m in on_k2]} vs "
          f"{[round(m['g_loss'], 5) for m in on_twin]}, d_loss "
          f"{[round(m['d_loss'], 6) for m in on_k2]} (max rel {rel:.2g}, rtol "
          f"{TRAIN_LOSS_RTOL})")
    print(f"[gan] the whole G gradient of the step, per leaf in units of "
          f"{GRAD_RTOL} x the leaf's max|g| (float64): K2 vs the twin beyond 1 "
          f"at {len(over)} of {len(rows)} leaves; the largest (|K2 - twin|, "
          f"|K2 - f64|, |twin - f64|): "
          + "; ".join(f"{n} {a:.2f}, {b:.2f}, {c:.2f}"
                      for n, (a, b, c) in over[:4]))

    # ---- the main path ----
    counted = {}
    work = tempfile.mkdtemp(prefix="tpusr_gan_")
    try:
        with count_plain_calls() as plain:
            torch.cuda.reset_peak_memory_stats(dev)
            state = trainer.init_state()
            reset_counts()
            host = []

            def gan_step(i):
                nonlocal state
                before = read_counts()
                h0 = time.perf_counter()
                state, m = trainer.train_step(state, *batch(i))
                torch.cuda.synchronize()
                host.append((time.perf_counter() - h0) * 1e3)
                after = read_counts()
                check({k: after[k] - before[k] for k in after} == per_step,
                      f"GAN step {i}: launches {after} - {before} != "
                      f"{per_step}")
                return m
            ms_out, dev_ms = timed_steps(gan_step, s.steps)
            peak = torch.cuda.max_memory_allocated(dev)
            mem = device_memory_mb(dev)
            g_losses = [float(m["g_loss"]) for m in ms_out]
            d_losses = [float(m["d_loss"]) for m in ms_out]
            check(all(math.isfinite(v) for v in g_losses + d_losses),
                  f"GAN losses {g_losses} {d_losses}")
            check(state.step == s.steps and state.g_opt["count"] == s.steps,
                  f"GAN state step {state.step}")
            before = read_counts()
            val_ms = time_compiled(trainer.val_step, state, *batch(0),
                                   iters=5) * 1e3
            after = read_counts()
            check(after["conv3x3_bias_act"] - before["conv3x3_bias_act"]
                  == 6 * n_fwd, f"val steps launched {after} - {before}")
            counted["steps"] = read_counts()["conv3x3_bias_act"]
            step_med, dev_med = float(np.median(host)), float(np.median(dev_ms))
            print_breakdown(f"ESRGAN g{s.growth}x{s.rrdb} GAN train", card,
                            lambda: trainer.train_step(state, *batch(0)),
                            dev_med)
            with trace(os.path.join(work, "trace")):
                trainer.train_step(state, *batch(1))
            events = json.load(open(os.path.join(work, "trace",
                                                 "trace.json")))["traceEvents"]
            k2_events = sum(1 for e in events if e.get("cat") == "kernel"
                            and "conv3x3" in e.get("name", ""))
            check(k2_events >= 2 * n_fwd - 1,
                  f"profiling.trace holds {k2_events} K2 kernel events")
            # the lead's lost records measure the profiler's loss at this
            # point of a long process; the lead must be twice that
            kept = trace_records(events, TRACE_LEAD_NAME)
            check(2 * kept["lead_lost"] <= TRACE_LEAD_KERNELS,
                  f"profiling.trace's lead lost {kept['lead_lost']} of "
                  f"{kept['lead']} kernel records: the lead is too short")
            check(kept["block_lost"] == 0,
                  f"profiling.trace lost {kept['block_lost']} of the step's "
                  f"{kept['block']} kernel records")
            del state
            torch.cuda.empty_cache()

            # the ESRGAN facade: fit, evaluate, save, from_trained
            fit_lr = (pool_lr[:s.fit_pairs] + 1.0) / 2.0
            fit_hr = (pool_hr[:s.fit_pairs] + 1.0) / 2.0
            val = slice(s.fit_pairs, s.fit_pairs + s.val_pairs)
            val_lr, val_hr = (pool_lr[val] + 1.0) / 2.0, (pool_hr[val] + 1.0) / 2.0
            n_train = s.fit_pairs // s.batch
            n_val = math.ceil(s.val_pairs / s.batch)
            m = ESRGAN(device=dev)
            m.setup_model(growth_channels=s.growth, num_rrdb_blocks=s.rrdb)
            reset_counts()
            hist, tt, _mt = m.fit(fit_lr, fit_hr, val_lr, val_hr,
                                  epochs=s.fit_epochs, batch_size=s.batch)
            want = launches_want(conv3x3_bias_act=s.fit_epochs * (
                n_train * (2 * n_fwd - 1) + n_val * n_fwd))
            check(read_counts() == want, f"facade fit launched "
                                         f"{read_counts()}, expected {want}")
            counted["facade_fit"] = read_counts()["conv3x3_bias_act"]
            reset_counts()
            ev = m.evaluate(val_lr, val_hr, batch_size=s.batch)
            check(read_counts() == launches_want(
                conv3x3_bias_act=n_val * n_fwd), f"evaluate {read_counts()}")
            counted["facade_evaluate"] = read_counts()["conv3x3_bias_act"]
            check(all(math.isfinite(v) for v in ev.values()), f"evaluate {ev}")
            path = m.save(work, "smoke")
            m2 = ESRGAN(device=dev)
            m2.setup_model(from_trained=True, generator_pretrained_path=path)
            check(m2.state.step == m.state.step and m2._arch == m._arch,
                  f"from_trained: step {m2.state.step}, arch {m2._arch}")
            lr_img = (smooth_images(g, 1, 3 * s.lr, 3, dev)[0] / 255.0
                      ).cpu().numpy()
            reset_counts()
            sr_a, _ = m.super_resolve_image(lr_img)
            sr_b, _ = m2.super_resolve_image(lr_img)
            counted["facade_sr"] = read_counts()["conv3x3_bias_act"]
            check(torch.equal(sr_a, sr_b),
                  "the restored generator's SR differs from the saved one's")
            del m, m2

            # the trainer's fit with a checkpoint each epoch, restored; with
            # no state it draws a generator and a discriminator anew
            reset_counts()
            ckpt = os.path.join(work, "ckpt")
            res = trainer.fit(fit_lr, fit_hr, val_lr, val_hr,
                              epochs=s.fit_epochs, batch_size=s.batch,
                              verbose=False, checkpoint_dir=ckpt,
                              checkpoint_every=1)
            want = {**want, "prng": drawn_leaves(gen8) + drawn_leaves(disc)}
            check(read_counts() == want, f"fit launched {read_counts()}, "
                                         f"expected {want}")
            counted["fit"] = read_counts()["conv3x3_bias_act"]
            saved = sorted(f for f in os.listdir(ckpt)
                           if not f.endswith(".json"))
            check(saved == [f"epoch_{e + 1:04d}" for e in range(s.fit_epochs)],
                  f"checkpoints {saved}")
            back = restore_checkpoint(ckpt, saved[-1], trainer.init_state())
            check(back.step == s.fit_epochs * n_train and all(
                torch.equal(back.g_params[k], res.state.g_params[k])
                for k in back.g_params), f"restored {saved[-1]}")
            del res, back
        check(plain.n == 0, f"plain twins were called on the GAN path: "
                            f"{plain.by_twin}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[gan] {card}: ESRGAN g{s.growth}x{s.rrdb} GAN step median "
          f"{step_med:.3f} ms by the host clock ({dev_med:.3f} ms between "
          f"CUDA events; {s.steps} steps, first {host[0]:.1f} ms), "
          f"{2 * n_fwd - 1} K2 launches a step ({n_fwd} forward + "
          f"{n_fwd - 1} dX), {n_fwd} a val step (val step {val_ms:.3f} ms, "
          f"time_compiled); peak memory {peak / 1e9:.2f} GB "
          f"(device_memory_mb: {mem['peak_mb']:.0f} MB); g_loss "
          f"{g_losses[0]:.4f} -> {g_losses[-1]:.4f}, d_loss {d_losses[0]:.4f}"
          f" -> {d_losses[-1]:.4f}; profiling.trace: {k2_events} K2 kernel "
          f"events in one step, kernel records lost: {kept['lead_lost']} of "
          f"the lead's {kept['lead']} launches, {kept['block_lost']} of the "
          f"step's {kept['block']}; plain twins called 0 times")
    print(f"[gan] {card}: ESRGAN facade fit {s.fit_epochs} epochs of "
          f"{s.fit_pairs} pairs: epoch times "
          f"{[round(v, 3) for v in tt.epoch_times_sec]} s, g_loss "
          f"{[round(v, 4) for v in hist['g_loss']]}, val_psnr "
          f"{[round(v, 2) for v in hist['val_psnr']]}; evaluate "
          f"{ {k: round(v, 4) for k, v in ev.items()} }; save -> from_trained"
          f": SR byte-equal; trainer fit with checkpoints {saved}, the last "
          f"restored equal")

    # ---- remat: the same steps, the forward recomputed in the backward ----
    def held_by_forward(tr) -> int:
        """Bytes the generator's forward leaves allocated for the backward
        (its output and saved activations)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        with torch.enable_grad():
            fake = tr._generate(st0.g_params, batch(0)[0])
        torch.cuda.synchronize()
        held_bytes = torch.cuda.memory_allocated(dev) - base
        del fake
        return held_bytes

    runs = {}
    with deterministic_cudnn():
        for remat in (False, True):
            tr = ESRGANTrainer(gen8, disc, vgg, remat=remat, device=dev)
            kept = held_by_forward(tr)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            st, out = steps_from(tr, tr.init_state(), s.remat_steps)
            runs[remat] = (st, out, read_counts()["conv3x3_bias_act"],
                           torch.cuda.max_memory_allocated(dev), kept)
            del tr
    (a, oa, la, pa, ka), (b, ob, lb, pb, kb) = runs[False], runs[True]
    check(la == s.remat_steps * (2 * n_fwd - 1)
          and lb == s.remat_steps * (3 * n_fwd - 1),
          f"remat launches {la} -> {lb}")
    check(oa == ob and all(torch.equal(a.g_params[k], b.g_params[k])
                           for k in a.g_params)
          and all(torch.equal(a.d_params[k], b.d_params[k])
                  for k in a.d_params), "remat changed the steps")
    check(kb < ka, f"remat kept {kb} bytes after the forward, not below {ka}")
    counted["remat"] = la + lb
    del runs, a, b
    print(f"[gan] {card}: remat: {s.remat_steps} steps bit for bit the same "
          f"(losses, G and D parameters; cuDNN deterministic in both); K2 "
          f"launches a step {2 * n_fwd - 1} -> {3 * n_fwd - 1} (the forward "
          f"again in the backward); memory the G forward keeps for the "
          f"backward {ka / 1e6:.1f} -> {kb / 1e6:.1f} MB; the step's peak "
          f"{pa / 1e9:.3f} -> {pb / 1e9:.3f} GB")

    # ---- bf16 training on K2-bf16 ----
    tr16 = ESRGANTrainer(gen8, disc, vgg, compute_dtype="bfloat16", device=dev)
    st16 = tr16.init_state()
    reset_counts()
    with dx_against_twin() as held16:
        bf_out = []
        for i in range(s.bf16_steps):
            before = read_counts()
            st16, m16 = tr16.train_step(st16, *batch(i))
            after = read_counts()
            check({k: after[k] - before[k] for k in after} == launches_want(
                conv3x3_bias_act_bf16=2 * n_fwd - 1),
                f"bf16 step {i}: launches {after} - {before}")
            bf_out.append({k: float(v) for k, v in m16.items()})

    def bf16_step(i):
        nonlocal st16
        st16, m = tr16.train_step(st16, *batch((s.bf16_steps + i) % s.steps))
        return m
    _, bf_ms = timed_steps(bf16_step, s.bf16_steps)    # no twin: timed
    bf16_launches = read_counts()["conv3x3_bias_act_bf16"]
    check(held16.n == s.bf16_steps * (n_fwd - 1), f"{held16.n} bf16 dX held")
    check(all(math.isfinite(m["g_loss"]) for m in bf_out), f"bf16 {bf_out}")
    check(all(v.dtype == torch.float32 for v in st16.g_params.values()),
          "bf16 training changed the master weights' dtype")
    del tr16, st16
    print(f"[gan] {card}: bf16: {s.bf16_steps} steps, {2 * n_fwd - 1} K2-bf16 "
          f"launches a step, every one of the {held16.n} dX launches within "
          f"k2_bf16_tolerance of its twin (max|d| {held16.err:.3g}); "
          f"{s.bf16_steps} more steps without the twin "
          f"{[round(v, 3) for v in bf_ms]} ms (CUDA events; f32 "
          f"{dev_med:.3f}); g_loss {[round(m['g_loss'], 4) for m in bf_out]} "
          f"(f32 {[round(m['g_loss'], 4) for m in on_k2]})")

    # ---- the facade's default width: growth 32, 23 RRDB ----
    gen32 = ESRGANGenerator(s.scale, s.wide_growth, s.wide_rrdb, device=dev,
                            key=gen(4))
    tr32 = ESRGANTrainer(gen32, disc, vgg, device=dev)
    wide = gan_train_layers(s, s.wide_growth, s.wide_rrdb)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    st32 = tr32.init_state()

    def wide_step(i):
        nonlocal st32
        st32, m = tr32.train_step(st32, *batch(i))
        return m
    out32, ms32 = timed_steps(wide_step, s.wide_steps)
    l32 = read_counts()["conv3x3_bias_act"]
    print_breakdown(f"ESRGAN g{s.wide_growth}x{s.wide_rrdb} GAN train", card,
                    lambda: tr32.train_step(st32, *batch(0)), ms32[-1])
    check(l32 == s.wide_steps * (2 * len(wide) - 1), f"g32 launched {l32}")
    counted["wide"] = l32
    g32 = [float(m["g_loss"]) for m in out32]
    check(all(math.isfinite(v) for v in g32), f"g32 losses {g32}")
    peak32 = torch.cuda.max_memory_allocated(dev)
    del tr32, st32, gen32
    torch.cuda.empty_cache()
    print(f"[gan] {card}: ESRGAN g{s.wide_growth}x{s.wide_rrdb}: "
          f"{s.wide_steps} steps {[round(v, 3) for v in ms32]} ms (CUDA "
          f"events), {2 * len(wide) - 1} K2 launches a step, peak "
          f"{peak32 / 1e9:.2f} GB, g_loss {[round(v, 4) for v in g32]}")

    convs8 = dict(gen8.named_modules())
    tot = train_k2_times(layers, convs8, dev, card, "gan-K2",
                         f"GAN step (g{s.growth}x{s.rrdb})")
    tot16 = train_k2_times(layers, convs8, dev, card, "gan-K2-bf16",
                           f"bf16 GAN step (g{s.growth}x{s.rrdb})",
                           torch.bfloat16)
    gen32 = ESRGANGenerator(s.scale, s.wide_growth, s.wide_rrdb, device=dev,
                            key=gen(4))
    tot32 = train_k2_times(wide, dict(gen32.named_modules()), dev, card,
                           "gan-K2-g32", f"GAN step (g{s.wide_growth}x"
                           f"{s.wide_rrdb})")
    del gen32
    torch.cuda.empty_cache()
    tot.update(launches=sum(counted.values()), err=worst["dx_err"],
               step_ms=step_med, wide=tot32)
    tot16.update(launches=bf16_launches, err=held16.err,
                 step_ms=float(np.median(bf_ms)))
    return {"k2": tot, "k2_bf16": tot16}


# -------------------------------------------------------------------- gate

@dataclass(frozen=True)
class GateSlice:
    """The serving gate at its full protocol on one seed of the hard task
    (tools/serving_gate.py ``run_gate``: 64 training and 128 eval images of
    512^2; VGG16 at full widths, 500 steps at batch 64; EDSR x4, 16 blocks,
    64 filters, 600 steps at batch 16; every mode and derived row), then the
    shipped mode served on its weights and the defect-detection comparison
    on 32 of its eval images."""
    task: str = "hard"
    images: int = 128
    size: int = 512
    clf_steps: int = 500
    edsr_steps: int = 600
    compare_images: int = 32
    shipped_row: str = "cascade_int8[vote_frac+guard]@frac=0.25"


def gate_launches(g: GateSlice, cfg: Slice, init: int | None = None) -> dict:
    """Kernel launches of one ``run_gate`` call with every mode: EDSR's
    training steps (K2 forward and dX), the SR variants chunked by 16 (f32
    and bf16 on K2, int8 on the dequant conv with the bf16 band, each int8
    variant calibrated by one f32 forward of the EDSR body), the per-patch
    int8 rows by 8 images (K3 + blocks 2-5 on K1) and the int8 trunk rows by
    16 (13 K1); K5's draws: each of the two surface sets 7 uniforms and
    the noise (the shuffle is drawn on the CPU), 3 randints for each of
    the three crop pools, a VGG16 step's batch and two dropout masks and an
    EDSR step's batch, and the ``init`` launches of its two models' builds
    (by default the full-width VGG16's and EDSR x4's drawn leaves)."""
    if init is None:
        init = (leaves_of("VGG16Classifier", num_classes=2)
                + leaves_of("EDSR", scale_factor=4))
    n_fwd = len(edsr_train_layers(TrainSlice()))
    sr_chunks = math.ceil(g.images / 16)
    pp_chunks = math.ceil(g.images / 8)
    k2_sr = sum(m for *_, m in k2_shapes(cfg))
    body = 2 * cfg.blocks + 2                # head, residual blocks, body
    per_patch_k1 = n_per_patch_k1(cfg)
    trunk_k1 = len(k1_shapes(cfg)) - per_patch_k1
    return launches_want(
        conv3x3_bias_act=g.edsr_steps * (2 * n_fwd - 1) + sr_chunks * k2_sr
        + 2 * body,
        conv3x3_bias_act_bf16=sr_chunks * (12 + k2_sr),
        conv3x3_int8_dequant=2 * sr_chunks * body,
        conv3x3_int8_requant=3 * pp_chunks * per_patch_k1
        + 4 * sr_chunks * trunk_k1,
        block1_int8=3 * pp_chunks,
        prng=2 * 8 + 3 * 3 + 3 * g.clf_steps + g.edsr_steps + init)


class patched:
    """Replace attributes of a module while the context is open:
    ``patched(mod, name=wrap)`` sets ``mod.name = wrap(original)``."""

    def __init__(self, mod, **wraps):
        self._mod, self._wraps = mod, wraps

    def __enter__(self):
        self._orig = {k: getattr(self._mod, k) for k in self._wraps}
        for k, wrap in self._wraps.items():
            setattr(self._mod, k, wrap(self._orig[k]))
        return self

    def __exit__(self, *exc):
        for k, v in self._orig.items():
            setattr(self._mod, k, v)


class trainer_steps:
    """Each trainer step's device time (CUDA events around it) and loss,
    recorded without a host sync while the context is open, by trainer."""

    def __enter__(self):
        from tpusr_torch.train import trainer as tr
        self.steps = {}
        self._saved = []
        for cls in (tr.SupervisedSRTrainer, tr.ClassifierTrainer):
            orig = cls.__dict__["train_step"]
            rec = self.steps.setdefault(cls.__name__, [])

            def timed(trainer, *a, _orig=orig, _rec=rec, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, m = _orig(trainer, *a, **kw)
                end.record()
                _rec.append((start, end, m["loss"]))
                return state, m
            self._saved.append((cls, orig))
            cls.train_step = timed
        return self

    def read(self, name: str) -> tuple[list, list]:
        """(step ms, losses) of the trainer class ``name``."""
        torch.cuda.synchronize()
        rec = self.steps[name]
        return ([s.elapsed_time(e) for s, e, _ in rec],
                [float(loss) for *_, loss in rec])

    def __exit__(self, *exc):
        for cls, orig in self._saved:
            cls.train_step = orig


def check_derived_rows(rep: dict, inputs: list) -> int:
    """The report's derived cascade rows against a recompute from its own
    raw votes: the classes the report stores, at the full-precision
    confidences and ranking scores ``derive_cascade_modes`` was given (the
    report keeps 4 decimals of each, checked here), with the eval labels
    that ``surface_labels`` recovers. Returns the number of rows checked."""
    from tpusr_torch.tools import serving_gate as sg
    rv = rep["raw_votes"]
    labels = sg.surface_labels(rep["seed"] + 1, rep["protocol"]["images"])
    derived = {m["mode"]: m for m in rep["modes"]
               if any(m["mode"].startswith(p + c)
                      for p in sg.CASCADE_PARENTS for c in "@[")}
    n_rows = 0
    for args, kw in inputs:
        raw, ref_cls, ref_conf, labels_h = args
        check(np.array_equal(labels_h, labels), "surface_labels did not "
              "recover the gate's eval labels")
        check(rv["reference"]["cls"] == ref_cls.tolist()
              and rv["reference"]["conf"] == np.round(ref_conf, 4).tolist(),
              "raw_votes['reference'] differs from the votes the rows used")
        votes = {}
        for name, (cls, conf) in raw.items():
            check(rv[name]["cls"] == cls.tolist()
                  and rv[name]["conf"] == np.round(conf, 4).tolist(),
                  f"raw_votes[{name!r}] differs from the votes the rows used")
            votes[name] = (np.asarray(rv[name]["cls"]), conf)
        scores = kw["trunk_scores"]
        for key, v in (scores or {}).items():
            check(rv[kw["parents"][0]][key] == np.round(v, 4).tolist(),
                  f"raw_votes[{kw['parents'][0]!r}][{key!r}] differs from the "
                  f"scores the rows used")
        rows = sg.derive_cascade_modes(votes, np.asarray(rv["reference"]["cls"]),
                                       ref_conf, labels, trunk_scores=scores,
                                       n_patches=kw["n_patches"],
                                       parents=kw["parents"],
                                       prefix=kw["prefix"])
        for row in rows:
            have = {k: v for k, v in derived.pop(row["mode"]).items()
                    if k not in ("passes_gate", "sr_psnr_vs_f32_db",
                                 "image_faithful")}
            check(have == row, f"derived row {row['mode']} differs from its "
                               f"recompute: {have} != {row}")
            n_rows += 1
    check(not derived, f"derived rows without parents: {sorted(derived)}")
    return n_rows


def jax_gate_row(g: GateSlice, seed: int) -> str:
    """The shipped row of ``seed`` in the JAX package's 12-seed gate run
    (``GATE_r05.json``, a TPU run's report), as agreement and flips."""
    with open(os.path.join(REPO, "GATE_r05.json")) as f:
        runs = json.load(f)["runs"]
    run = next((r for r in runs if r["seed"] == seed), None)
    if run is None:
        return "(no such seed)"
    m = next(m for m in run["modes"] if m["mode"] == g.shipped_row)
    return f"{m['vote_agreement']:.4f} ({m['flips']} flips)"


# seed 6's gate loop on the card against JAX's on the CPU (the committed
# fixture): |loss difference| at steps 0, 1 and 2 measured on an NVIDIA
# H100 80GB HBM3 at 700 W as 6.0e-8, 2.3e-6 and 1.25e-5 (cuDNN's float32
# sums in another order than XLA's, growing through Adam's first steps);
# the bound is step 2's in tests/test_torch_gate_trajectory.py
TRAJ_SEED, TRAJ_STEPS, TRAJ_ATOL = 6, 300, 1e-4
GATE_FIXTURE = os.path.join(REPO, "tests", "data", "gate_trajectory",
                            "jax_cpu.json")


def jax_fixture(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """JAX's (loss, train-batch accuracy) per step of seed ``seed``'s gate
    classifier loop on the CPU, as float32 arrays (``GATE_FIXTURE``, written
    by ``make_fixture.py`` beside it)."""
    import struct
    with open(GATE_FIXTURE) as f:
        run = json.load(f)["seeds"][str(seed)]

    def f32(hexes):
        return np.array([struct.unpack(">f", bytes.fromhex(h))[0]
                         for h in hexes], dtype=np.float32)
    return f32(run["loss"]), f32(run["accuracy"])


def gate_trajectory(dev, card: str) -> dict:
    """Seed ``TRAJ_SEED``'s gate classifier loop on the card for
    ``TRAJ_STEPS`` steps (``tools/gate_trajectory.Loop``, cuDNN
    deterministic as the gate trains): its losses at steps 0-2 within
    ``TRAJ_ATOL`` of JAX's on the CPU, and the first step whose loss falls
    under 0.5 beside JAX's, with its K5 launches."""
    from tpusr_torch.tools import gate_trajectory as gt

    reset_counts()
    t0 = time.perf_counter()
    loop = gt.Loop(TRAJ_SEED, dev)
    with deterministic_cudnn():
        run = loop.run(TRAJ_STEPS)
    wall = time.perf_counter() - t0
    got = read_counts()
    # the surfaces, the crop pool, the batches and masks, the VGG16 built
    want = launches_want(prng=8 + 3 + 3 * TRAJ_STEPS
                         + leaves_of("VGG16Classifier", num_classes=2))
    check(got == want, f"[gate-trajectory] launches {got} != {want}")
    K5_BY_PATH["gate_trajectory"] = got["prng"]
    jax_loss, _ = jax_fixture(TRAJ_SEED)
    loss = np.array(run["loss"], np.float32)
    d = np.abs(loss[:3] - jax_loss[:3])
    esc, jax_esc = gt.first_escape(loss), gt.first_escape(jax_loss)
    print(f"[gate-trajectory] {card}: seed {TRAJ_SEED}'s VGG16 loop, "
          f"{TRAJ_STEPS} steps on the card in {wall:.1f} s; |loss - JAX's on "
          f"the CPU| at steps 0-2 {[float(v) for v in d]} (max "
          f"{float(d.max()):.3g}, bound {TRAJ_ATOL}); loss at steps 3-6 "
          f"{[round(float(v), 6) for v in loss[3:7]]} (JAX "
          f"{[round(float(v), 6) for v in jax_loss[3:7]]}); first step under "
          f"{gt.ESCAPE_LOSS}: the card {esc}, JAX on the CPU {jax_esc}; "
          f"K5 launches {got['prng']}")
    check(float(d.max()) <= TRAJ_ATOL, f"[gate-trajectory] steps 0-2 are "
                                       f"{d.max()} from JAX's")
    check(all(math.isfinite(v) for v in run["loss"]),
          "[gate-trajectory] a non-finite loss")
    return {"max_abs_d_steps_0_2": float(d.max()), "escape": esc,
            "jax_escape": jax_esc, "s": wall}


def phase_gate(g: GateSlice, cfg: Slice, dev, seed: int, sync,
               card: str) -> dict:
    """The serving gate on the card at its full protocol, through
    ``tools/serving_gate.run_gate``: training, every mode and derived row,
    with the launch counts the modes imply and no plain twin on the card;
    then the shipped mode served on the gate's trained weights, and the
    defect-detection comparison. Returns the gate's launches and what
    ``phase_serve`` serves: the trained EDSR and VGG16, the eval LR images
    and the gate's reference classes."""
    from tpusr_torch.core.resize import resize
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply
    from tpusr_torch.models.edsr_quant import make_fused_sr_apply_int8
    from tpusr_torch.models.layers import pixel_shuffle
    from tpusr_torch.models.quant import quantized_vgg16_apply
    from tpusr_torch.pipeline import PipelineServer, make_serving_pipeline
    from tpusr_torch.pipeline.defect_pipeline import (
        run_defect_detection_comparison)
    from tpusr_torch.tools import serving_gate as sg

    task = sg.TASKS[g.task]
    kept = {"images": [], "derive": [], "wall": {}}

    def keep(key):
        def wrap(orig):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                sync()
                kept["wall"][key] = time.perf_counter() - t0
                kept[key] = out
                return out
            return call
        return wrap

    def keep_images(orig):
        def call(*a, **kw):
            kept["images"].append(orig(*a, **kw))
            return kept["images"][-1]
        return call

    def keep_derive(orig):
        def call(*a, **kw):
            kept["derive"].append((a, kw))
            return orig(*a, **kw)
        return call

    # ---- the main path: run_gate at the full protocol ----
    reset_counts()
    n0 = INIT_K5["n"]
    t0 = time.perf_counter()
    with count_plain_calls() as plain, trainer_steps() as steps, \
            patched(sg, train_classifier=keep("clf"), train_edsr=keep("edsr"),
                    make_surface_images=keep_images,
                    derive_cascade_modes=keep_derive):
        rep = sg.run_gate(g.images, g.size, g.clf_steps, g.edsr_steps, seed,
                          verbose=False, amp_range=task["amp_range"],
                          noise=task["noise"],
                          coverage_range=task["coverage_range"], device=dev)
    gate_s = time.perf_counter() - t0
    launches = read_counts()
    want = gate_launches(g, cfg)
    check(init_since(n0) == want["prng"] - gate_launches(g, cfg, 0)["prng"],
          f"[gate] its model builds launched K5 {init_since(n0)} times")
    print(f"[gate] run_gate task {g.task} seed {seed}: {g.images} eval images "
          f"of {g.size}^2, {rep['protocol']['patches_per_image']} patches "
          f"each; {gate_s:.1f} s; launches {launches} (expected {want}); "
          f"plain twins on the card {plain.by_twin}")
    check(launches == want, f"gate launch counts {launches} != {want}")
    check(plain.n == 0, f"plain twins called on the card: {plain.by_twin}")
    K5_BY_PATH["gate"] = launches["prng"]

    clf_ms, clf_losses = steps.read("ClassifierTrainer")
    edsr_ms, edsr_losses = steps.read("SupervisedSRTrainer")
    check(len(clf_ms) == g.clf_steps and len(edsr_ms) == g.edsr_steps,
          f"trainer steps {len(clf_ms)}, {len(edsr_ms)}")
    check(all(math.isfinite(v) for v in clf_losses + edsr_losses),
          "a non-finite training loss")
    first, last = np.mean(edsr_losses[:10]), np.mean(edsr_losses[-10:])
    check(last < first, f"EDSR loss did not fall: {first} -> {last}")
    print(f"[gate] {card}: VGG16 {g.clf_steps} steps in "
          f"{kept['wall']['clf']:.2f} s (median step {np.median(clf_ms):.3f} "
          f"ms, CUDA events), loss {np.mean(clf_losses[:10]):.4f} -> "
          f"{np.mean(clf_losses[-10:]):.4f} (means of the first and last 10), "
          f"final train-batch accuracy {rep['training']['clf_final_train_acc']:.3f};"
          f" EDSR x4 {g.edsr_steps} steps in {kept['wall']['edsr']:.2f} s "
          f"(median step {np.median(edsr_ms):.3f} ms), loss {first:.5f} -> "
          f"{last:.5f}")

    base = [m for m in rep["modes"] if "escalation_fraction" not in m]
    for m in base:
        print(f"[gate] {m['mode']:36s} agreement {m['vote_agreement']:.4f} "
              f"flips {m['flips']:3d} conf drift mean "
              f"{m['mean_abs_conf_drift']:.4f} max {m['max_abs_conf_drift']:.4f}"
              f" accuracy {m['accuracy']:.4f}"
              + (f" SR {m['sr_psnr_vs_f32_db']:.2f} dB"
                 if "sr_psnr_vs_f32_db" in m else ""))
    print("[gate] SR drift against the f32 SR: "
          + ", ".join(f"{k} {rep[k]:.4f}" for k in (
              "psnr_int8_sr_vs_f32_sr_db", "ssim_int8_sr_vs_f32_sr",
              "psnr_int8_noborder_sr_vs_f32_sr_db",
              "ssim_int8_noborder_sr_vs_f32_sr", "psnr_bf16_sr_vs_f32_sr_db",
              "ssim_bf16_sr_vs_f32_sr")))
    derived = [m for m in rep["modes"] if "escalation_fraction" in m]
    passing = sum(m["passes_gate"] for m in rep["modes"])
    print(f"[gate] reference_accuracy {rep['reference_accuracy']:.4f}, "
          f"boundary images {rep['reference_boundary_images']}, meaningful "
          f"{rep['meaningful']}; {len(base)} modes and {len(derived)} derived "
          f"rows, {passing} of {len(rep['modes'])} at >= 99% agreement")
    shipped = next(m for m in rep["modes"] if m["mode"] == g.shipped_row)
    print(f"[gate] shipped row {g.shipped_row}: agreement "
          f"{shipped['vote_agreement']:.4f}, flips {shipped['flips']}, "
          f"escalation {shipped['escalation_fraction']:.4f}, unescalated flips "
          f"{shipped['unescalated_flips']}, guard canary "
          f"{shipped['guard_canary']:.4f} (tripped "
          f"{shipped['guard_triggered']}), passes {shipped['passes_gate']}")
    print(f"[gate] shipped row, seed {seed}, on JAX's streams: the port "
          f"{shipped['vote_agreement']:.4f} ({shipped['flips']} flips) beside "
          f"the JAX package's GATE_r05.json {jax_gate_row(g, seed)}")
    n_rows = check_derived_rows(rep, kept["derive"])
    check(json.loads(json.dumps(rep)) == rep, "the report does not round-trip "
                                              "through json")
    print(f"[gate] {n_rows} derived rows equal their recompute from the "
          f"report's raw votes; the report round-trips through json")

    # ---- the shipped mode served on the gate's trained weights ----
    clf, _ = kept["clf"]
    edsr = kept["edsr"]
    (hr_train, y_train), (hr_eval, y_eval) = kept["images"]
    calib = sg.make_crop_pool(seed + 300, hr_train, y_train, 32, sg.PATCH)[0]
    lr_eval = resize(hr_eval, (cfg.lr, cfg.lr), "area")
    ref_cls = np.asarray(rep["raw_votes"]["reference"]["cls"])

    def build(guard):
        return make_serving_pipeline(
            edsr, clf, (cfg.lr, cfg.lr), cfg.scale, patch=cfg.patch,
            stride=cfg.stride, sr_mode="f32", clf_mode="cascade_int8",
            calib_patches=calib, cascade_escalate_frac=cfg.frac,
            cascade_escalate_score="vote_frac", cascade_guard_threshold=guard,
            device=dev)

    pipe = build(cfg.guard)
    votes = pipe.cascade_votes
    server = PipelineServer(pipe, batch_size=cfg.batch, max_wait_ms=50.0)
    futures = [server.submit(im) for im in lr_eval.cpu().numpy()]
    with count_plain_calls() as plain:
        reset_counts()
        with server:
            results = [f.result(timeout=600) for f in futures]
        served = read_counts()
    trips = votes.guard_trips
    n_batches = math.ceil(g.images / cfg.batch)
    want = launches_want(
        conv3x3_int8_requant=n_batches * len(k1_shapes(cfg))
        + trips * n_per_patch_k1(cfg),
        conv3x3_bias_act=n_batches * sum(m for *_, m in k2_shapes(cfg)),
        block1_int8=n_batches + trips)
    check(served == want, f"served launch counts {served} != {want}")
    check(plain.n == 0, f"plain twins called serving: {plain.by_twin}")
    classes = np.array([r["class"] for r in results])
    confs = np.array([r["confidence"] for r in results])
    check(bool(((confs >= 0) & (confs <= 1)).all()), "confidence out of [0, 1]")
    batch = lr_eval[:cfg.batch].contiguous()
    unguarded = build(None)
    with torch.inference_mode():
        on_ms = min(host_ms(lambda: pipe(batch, n_valid=cfg.batch), sync)
                    for _ in range(3))
        off_ms = min(host_ms(lambda: unguarded(batch, n_valid=cfg.batch), sync)
                     for _ in range(3))
    print(f"[gate-serve] shipped mode (f32 SR, cascade_int8 vote_frac frac "
          f"{cfg.frac}, guard {cfg.guard}) on the gate's trained weights: "
          f"{g.images} eval images by PipelineServer at batch {cfg.batch}; "
          f"guard trips {trips} of {n_batches} batches; launches {served}; "
          f"agreement with the gate's reference classes "
          f"{float((classes == ref_cls).mean()):.4f} "
          f"({int((classes != ref_cls).sum())} flips), accuracy "
          f"{float((classes == y_eval.cpu().numpy()).mean()):.4f}")
    print(f"[gate-serve] {card}, batch {cfg.batch} (host clock, best of 3): "
          f"guard on {on_ms:.2f} ms per batch, {cfg.batch / on_ms * 1e3:.1f} "
          f"img/s; guard off {off_ms:.2f} ms, {cfg.batch / off_ms * 1e3:.1f} "
          f"img/s")
    qtree = pipe.qtree
    del pipe, unguarded, server

    # ---- the defect-detection comparison on the gate's weights ----
    n = g.compare_images
    f32_fn, r = make_fused_sr_apply(edsr)
    bf16_fn, _ = make_fused_sr_apply(edsr, torch.bfloat16)
    int8_fn, _ = make_fused_sr_apply_int8(edsr, sample_lr=lr_eval[:4])
    methods = {
        "bicubic": lambda x: resize(x, (g.size, g.size), "bicubic").clamp(0, 1),
        "edsr_f32": lambda x: pixel_shuffle(f32_fn(x), r),
        "edsr_bf16": lambda x: pixel_shuffle(bf16_fn(x), r).float(),
        "edsr_int8": lambda x: pixel_shuffle(int8_fn(x), r)}
    with count_plain_calls() as plain:
        reset_counts()
        res = run_defect_detection_comparison(
            methods, lambda p: quantized_vgg16_apply(qtree, p),
            lr_eval[:n].cpu().numpy(), hr_eval[:n].cpu().numpy(),
            y_eval[:n].cpu().numpy(), cfg.patch, cfg.stride, cfg.batch,
            verbose=False, device=dev)
        compared = read_counts()
    calls = 1 + math.ceil(n / cfg.batch)       # the warm-up and the batches
    k2_sr = sum(m for *_, m in k2_shapes(cfg))
    want = launches_want(
        conv3x3_int8_requant=len(methods) * calls * 13,
        conv3x3_bias_act=calls * k2_sr,
        conv3x3_bias_act_bf16=calls * (k2_sr + 12),
        conv3x3_int8_dequant=calls * (2 * cfg.blocks + 2))
    check(compared == want, f"comparison launch counts {compared} != {want}")
    check(plain.n == 0, f"plain twins called comparing: {plain.by_twin}")
    for name, v in res.items():
        check(math.isfinite(v["psnr_mean"]) and math.isfinite(v["ssim_mean"]),
              f"{name}: PSNR/SSIM not finite")
        print(f"[gate-compare] {name:9s} accuracy {v['accuracy']:.4f} PSNR "
              f"{v['psnr_mean']:.2f} dB SSIM {v['ssim_mean']:.4f} against HR; "
              f"{v['time_sec'] * 1e3:.1f} ms for {n} images (host clock, "
              f"batches of {cfg.batch}); confusion "
              f"{v['confusion_matrix'].tolist()}")
    print(f"[gate-compare] {card}: per-patch int8 classifier (13 K1 a call), "
          f"{n} eval images; launches {compared}")
    del methods, f32_fn, bf16_fn, int8_fn
    torch.cuda.empty_cache()
    gate_trajectory(dev, card)
    return launches, {"edsr": edsr, "clf": clf, "lr_eval": lr_eval,
                      "ref_cls": ref_cls}


# -------------------------------------------------------------------- serve

SERVE_LEVELS = (1, 16)       # client concurrency (bench_serving.py's 1 and 16)
SERVE_SR_CHECKS = 8          # /sr answers held byte for byte
SERVE_CALIB_SEED = 500       # the calibration images' draw (eval is seed + 1)


def http(url: str, body: bytes | None = None) -> tuple[int, bytes]:
    """(status, body) of one request, a GET when ``body`` is None."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class batch_log:
    """While open, ``PipelineServer`` stamps each request's submit time and
    logs each batch it runs: (start, end, requests, submit times); ``pipes``
    keeps the pipelines it served."""

    def __enter__(self):
        from tpusr_torch.pipeline import serving
        self.batches, self.pipes = [], set()
        cls = serving.PipelineServer
        self._cls, self._orig = cls, (cls.submit, cls._run_batch)
        orig_submit, orig_run = self._orig

        def submit(srv, img):
            t = time.perf_counter()
            fut = orig_submit(srv, img)
            fut.t_submit = t
            return fut

        def run(srv, batch):
            t0 = time.perf_counter()
            orig_run(srv, batch)
            self.batches.append((t0, time.perf_counter(), len(batch),
                                 [getattr(f, "t_submit", t0) for _, f in batch]))
            self.pipes.add(srv.pipeline)
        cls.submit, cls._run_batch = submit, run
        return self

    def __exit__(self, *exc):
        self._cls.submit, self._cls._run_batch = self._orig


def phase_serve(g: GateSlice, cfg: Slice, dev, seed: int, sync, card: str,
                trained: dict) -> dict:
    """The HTTP serving tier on the gate's trained weights, through the
    port's ``serve`` command in its default mode: the trained EDSR and VGG16
    saved by the facades, 16 calibration LR images written as PNG, the
    command run on a thread; then GET /healthz, the 128 eval LR images as
    PNG to /classify at client concurrency 1 and 16 (each level driven with
    the launch counts set to 0 just before it and read just after), /sr
    answers held byte for byte against the pipeline's direct SR, the error
    codes, and the command's exit on ``--max-requests``. Returns the launches
    of each level."""
    import shutil
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from tpusr_torch.cli.__main__ import (_gate_certification_note,
                                         build_parser, main as cli_main)
    from tpusr_torch.core.resize import resize
    from tpusr_torch.models.api import EDSR as EDSRFacade, FineTunedVGG16
    from tpusr_torch.pipeline.imdecode import decode_image_u8
    from tpusr_torch.pipeline.png import decode_png, encode_png, encode_png_u8
    from tpusr_torch.tools import serving_gate as sg

    t_setup = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        # ---- the checkpoints, through the facades ----
        paths = []
        for facade, module, kw in (
                (EDSRFacade, trained["edsr"], dict(scale_factor=cfg.scale)),
                (FineTunedVGG16, trained["clf"],
                 dict(input_shape=(cfg.patch, cfg.patch, 3), num_classes=2))):
            f = facade(device=dev)
            f.setup_model(**kw)
            weights = dict(module.named_parameters())
            with torch.no_grad():
                for name, p in f.state.params.items():
                    p.copy_(weights[name])
            f.trained = True
            paths.append(f.save(work, "gate"))
        # ---- 16 calibration LR images, drawn as the gate draws its eval set
        task = sg.TASKS[g.task]
        k5_before = k5_launches()
        hr_cal, _ = sg.make_surface_images(
            seed + SERVE_CALIB_SEED, 16, g.size, amp_range=task["amp_range"],
            noise=task["noise"], coverage_range=task["coverage_range"],
            device=dev)
        K5_BY_PATH["serve_calibration"] = k5_launches() - k5_before
        check(K5_BY_PATH["serve_calibration"] == 8, "the calibration "
              f"surfaces: {K5_BY_PATH['serve_calibration']} K5 launches, not "
              f"8 (7 uniforms and the noise)")
        calib_dir = os.path.join(work, "calib")
        os.makedirs(calib_dir)
        for i, im in enumerate(resize(hr_cal, (cfg.lr, cfg.lr), "area")
                               .clamp(0, 1).cpu().numpy()):
            with open(os.path.join(calib_dir, f"c{i:02d}.png"), "wb") as fh:
                fh.write(encode_png(im))
        lr_eval = trained["lr_eval"].cpu().numpy()
        ref_cls = trained["ref_cls"]
        bodies = [encode_png(im) for im in lr_eval]
        n_sr = min(SERVE_SR_CHECKS, len(bodies))
        # the formats beside PNG: each committed LR body, and the PNG twin
        # of its decode, to /classify and /sr
        fmt_bodies = {label: [format_fixture(f"lr{i}{suffix}")
                              for i in range(4)] * SERVE_FORMAT_REPEATS
                      for label, suffix in SERVE_FORMATS.items()}
        once = {label: format_fixture(name)
                for label, name in SERVE_ONCE.items()}
        twins = {b: encode_png_u8(decode_image_u8(b))
                 for b in [*(b for fb in fmt_bodies.values() for b in fb),
                           *once.values()]}
        n_fmt = 2 * (sum(map(len, fmt_bodies.values()))
                     + len(set(twins.values()))) + len(once)
        n_post = len(SERVE_LEVELS) * len(bodies) + n_sr + n_fmt + 2
        port_file = os.path.join(work, "port")
        argv = ["serve", "--edsr-ckpt", paths[0], "--vgg16-ckpt", paths[1],
                "--scale", str(cfg.scale), "--lr-size", str(cfg.lr),
                "--patch", str(cfg.patch), "--stride", str(cfg.stride),
                "--calib-dir", calib_dir, "--port", "0", "--port-file",
                port_file, "--max-requests", str(n_post)]
        err = []

        def run():
            try:
                cli_main(argv)
            except BaseException as e:  # noqa: BLE001 - reported below
                err.append(e)

        with batch_log() as log, count_plain_calls() as plain:
            thread = threading.Thread(target=run, daemon=True)
            thread.start()
            deadline = time.monotonic() + 300
            while (not os.path.exists(port_file) and not err
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            check(not err, f"serve failed to start: {err[:1]}")
            check(os.path.exists(port_file), "serve never wrote its port")
            base = f"http://127.0.0.1:{open(port_file).read().strip()}"
            startup_s = time.perf_counter() - t_setup
            status, body = http(base + "/healthz")
            cfg_echo = json.loads(body)["config"]
            check(status == 200 and cfg_echo["sr_mode"] == "f32"
                  and cfg_echo["clf_mode"] == "cascade_int8"
                  and cfg_echo["cascade_escalate_score"] == "vote_frac"
                  and cfg_echo["cascade_escalate_frac"] == cfg.frac
                  and cfg_echo["cascade_guard_threshold"] == cfg.guard
                  and cfg_echo["batch_size"] == cfg.batch,
                  f"/healthz config {cfg_echo}")
            # the note of the served mode (the default), read from
            # GATE_torch.json (the 12-seed report fails it on three seeds)
            want_note = _gate_certification_note(
                build_parser().parse_args(argv))
            check("GATE_torch.json" in cfg_echo.get("gate", "")
                  and cfg_echo["gate"] == want_note,
                  f"/healthz gate note {cfg_echo.get('gate')}")
            pipe = next(iter(log.pipes))
            votes = pipe.cascade_votes

            def classify(b):
                t0 = time.perf_counter()
                st, data = http(base + "/classify", b)
                return st, data, (time.perf_counter() - t0) * 1e3

            levels, launches = {}, {}
            for conc in SERVE_LEVELS:
                n0, trips0 = len(log.batches), votes.guard_trips
                reset_counts()
                t0 = time.perf_counter()
                if conc == 1:
                    answers = [classify(b) for b in bodies]
                else:
                    with ThreadPoolExecutor(conc) as pool:
                        answers = list(pool.map(classify, bodies))
                wall = time.perf_counter() - t0
                got = read_counts()
                batches = log.batches[n0:]
                trips = votes.guard_trips - trips0
                check(all(st == 200 for st, *_ in answers),
                      f"concurrency {conc}: statuses "
                      f"{sorted({st for st, *_ in answers})}")
                res = [json.loads(d) for _, d, _ in answers]
                classes = np.array([r["class"] for r in res])
                lat = np.array([ms for *_, ms in answers])
                agree = float((classes == ref_cls).mean())
                want = launches_want(
                    conv3x3_int8_requant=len(batches) * len(k1_shapes(cfg))
                    + trips * n_per_patch_k1(cfg),
                    conv3x3_bias_act=len(batches)
                    * sum(m for *_, m in k2_shapes(cfg)),
                    block1_int8=len(batches) + trips)
                check(got == want, f"concurrency {conc}: launches {got} != "
                                   f"{want} for {len(batches)} batches")
                check(sum(n for _, _, n, _ in batches) == len(bodies),
                      f"concurrency {conc}: batches hold "
                      f"{sum(n for _, _, n, _ in batches)} requests")
                check(agree >= 0.99, f"concurrency {conc}: classes agree with "
                                     f"the gate's reference on {agree:.4f} < "
                                     f"0.99")
                wait = np.array([1e3 * (b0 - t) for b0, _, _, ts in batches
                                 for t in ts])
                run_ms = np.array([1e3 * (b1 - b0) for b0, b1, _, _ in batches])
                levels[conc] = {
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "req_per_s": len(bodies) / wall, "batches": len(batches),
                    "mean_fill": float(np.mean([n for _, _, n, _ in batches])),
                    "queue_wait_ms": float(np.mean(wait)),
                    "batch_ms": float(np.median(run_ms)),
                    "trips": trips, "agreement": agree}
                launches[conc] = got
                v = levels[conc]
                print(f"[serve] {card}: concurrency {conc}: {len(bodies)} "
                      f"POST /classify (PNG, {cfg.lr}^2) in {wall:.3f} s, "
                      f"{v['req_per_s']:.1f} req/s; latency p50 "
                      f"{v['p50_ms']:.2f} ms, p99 {v['p99_ms']:.2f} ms (client "
                      f"clock, POST to reply); {v['batches']} batches, mean "
                      f"fill {v['mean_fill']:.2f} of {cfg.batch}; mean queue "
                      f"wait {v['queue_wait_ms']:.2f} ms, median batch "
                      f"{v['batch_ms']:.2f} ms (server clock); guard trips "
                      f"{trips}; classes agree with the gate's reference on "
                      f"{agree:.4f} ({int((classes != ref_cls).sum())} flips);"
                      f" launches {got}")
            # ---- /sr, one request per batch (the request and 15 pad copies
            # of it): byte for byte the pipeline's direct SR of the image
            # in a batch of 16 distinct eval images
            lr_dev = torch.as_tensor(lr_eval, device=dev)
            sr_diff_alone = 0
            for i in range(n_sr):
                status, png_body = http(base + "/sr", bodies[i])
                check(status == 200, f"/sr status {status}")
                img = torch.as_tensor(decode_png(bodies[i]), device=dev)
                mates = torch.cat([img[None], lr_dev[:i],
                                   lr_dev[i + 1:]])[:cfg.batch]
                with torch.inference_mode():
                    direct = pipe.sr_apply(mates)
                    alone = pipe.sr_apply(img[None])
                check(encode_png(direct[0].cpu().numpy()) == png_body,
                      f"/sr image {i} differs from the pipeline's direct SR "
                      f"beside 15 other images")
                sr_diff_alone += int(encode_png(alone[0].cpu().numpy())
                                     != png_body)
            # what a served batch adds to the pipeline's own time: the
            # server copies all 16 SR images (pads included) to the host
            x16 = lr_dev[:cfg.batch]
            with torch.inference_mode():
                pipe_ms = min(host_ms(lambda: pipe(x16, n_valid=1), sync)
                              for _ in range(3))
                d2h_ms = min(host_ms(lambda: direct.cpu(), sync)
                             for _ in range(3))
            # ---- each format's bodies answered as their PNG twins are,
            # the launches counted over them and their twins
            n0, trips0 = len(log.batches), votes.guard_trips
            reset_counts()
            t0 = time.perf_counter()
            twin_answers = {}
            for twin in dict.fromkeys(twins.values()):
                twin_answers[twin] = {p: http(base + p, twin)
                                      for p in ("/classify", "/sr")}
            fmt_ms = {}
            for label, fb in fmt_bodies.items():
                t1 = time.perf_counter()
                for b in fb:
                    for p in ("/classify", "/sr"):
                        got_p = http(base + p, b)
                        want_p = twin_answers[twins[b]][p]
                        check(got_p[0] == want_p[0] == 200,
                              f"{label} body to {p}: status {got_p[0]}, its "
                              f"PNG twin {want_p[0]}")
                        if p == "/sr":
                            check(got_p[1] == want_p[1], f"{label} body: /sr "
                                  f"differs from its PNG twin's")
                        else:
                            check(json.loads(got_p[1])["class"] == json.loads(
                                want_p[1])["class"], f"{label} body: class "
                                f"differs from its PNG twin's")
                fmt_ms[label] = (time.perf_counter() - t1) * 1e3 / (2 * len(fb))
            for label, b in once.items():
                t1 = time.perf_counter()
                got_p = http(base + "/classify", b)
                want_p = twin_answers[twins[b]]["/classify"]
                check(got_p[0] == want_p[0] == 200 and json.loads(got_p[1])[
                    "class"] == json.loads(want_p[1])["class"],
                    f"{label} body to /classify: {got_p[0]} {got_p[1][:80]!r},"
                    f" its PNG twin {want_p[0]} {want_p[1][:80]!r}")
                fmt_ms[label] = (time.perf_counter() - t1) * 1e3
            fmt_s = time.perf_counter() - t0
            fmt_launches = read_counts()
            # a batch is logged just after its replies are sent: wait for
            # the last one
            n_req = 2 * (sum(map(len, fmt_bodies.values()))
                         + len(twin_answers)) + len(once)
            deadline = time.monotonic() + 10
            while (sum(n for _, _, n, _ in log.batches[n0:]) < n_req
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            check(sum(n for _, _, n, _ in log.batches[n0:]) == n_req,
                  f"format bodies: the batches hold "
                  f"{sum(n for _, _, n, _ in log.batches[n0:])} of {n_req} "
                  f"requests")
            fmt_batches = len(log.batches) - n0
            fmt_trips = votes.guard_trips - trips0
            want = launches_want(
                conv3x3_int8_requant=fmt_batches * len(k1_shapes(cfg))
                + fmt_trips * n_per_patch_k1(cfg),
                conv3x3_bias_act=fmt_batches
                * sum(m for *_, m in k2_shapes(cfg)),
                block1_int8=fmt_batches + fmt_trips)
            check(fmt_launches == want, f"format bodies: launches "
                  f"{fmt_launches} != {want} for {fmt_batches} batches")
            # ---- the error codes (the two 400s are the last POSTs counted)
            check(http(base + "/nope", bodies[0])[0] == 404, "POST /nope")
            check(http(base + "/nope")[0] == 404, "GET /nope")
            status, body = http(base + "/classify", b"not an image")
            check(status == 400, f"a non-image body got {status}")
            status, body = http(base + "/classify",
                                b"\xff\xd8\xff\xe0" + bytes(64))
            check(status == 400 and "JPEG" in json.loads(body)["error"],
                  f"a JPEG body got {status} {body[:120]!r}")
            thread.join(timeout=60)
            check(not thread.is_alive(), f"serve did not exit after "
                                         f"{n_post} requests")
            check(not err, f"serve failed: {err[:1]}")
            check(plain.n == 0, f"plain twins on the card serving: "
                                f"{plain.by_twin}")
        print(f"[serve] `python -m tpusr_torch.cli serve` (default mode) up "
              f"in {startup_s:.1f} s (facades, calibration on 16 PNGs, the "
              f"warm-up batch); /healthz gate note: {cfg_echo['gate']}; "
              f"{n_sr} /sr answers equal byte for byte the "
              f"pipeline's direct SR of the image beside 15 other eval images "
              f"({sr_diff_alone} of {n_sr} differ from the SR of the image "
              f"alone, N = 1, which the server never runs); 400 for a "
              f"non-image and a truncated JPEG body, 404 for /nope; exited after "
              f"{n_post} POSTs; no plain twin on the card")
        print(f"[serve] {card}: {SERVE_FORMAT_REPEATS * 4} {cfg.lr}^2 LR "
              f"bodies of each of {', '.join(fmt_bodies)} to /classify and "
              f"/sr, and one each of {', '.join(once)} to /classify, at "
              f"concurrency 1 answer as their PNG twins (classes "
              f"equal, /sr byte for byte) in {fmt_s:.1f} s with the twins "
              f"({fmt_batches} batches, guard trips {fmt_trips}, launches "
              f"{fmt_launches}); "
              f"mean ms a POST: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in fmt_ms.items()))
        print(f"[serve] {card}: where a batch's time goes: the pipeline "
              f"on one request padded to {cfg.batch} {pipe_ms:.2f} ms (host "
              f"clock, best of 3); copying its {cfg.batch} SR images to the "
              f"host {d2h_ms:.2f} ms; the server's median "
              f"batch at concurrency 1 {levels[1]['batch_ms']:.2f} ms")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"levels": levels, "launches": launches,
            "format_launches": fmt_launches}


# ----------------------------------------------------------------- commands

@dataclass(frozen=True)
class CommandsSlice:
    """The reference's commands on its own dataset layout (HR/LR PNG pairs,
    ``interp_map.pkl``, ``class_map.pkl``), made on the card: print
    surfaces of the hard task degraded x0.25 by ``degrade_image``."""
    images: int = 16             # per set: a training set and a prediction set
    size: int = 512              # HR side; LR 128
    edsr_epochs: int = 2
    srcnn_epochs: int = 1
    vgg16_epochs: int = 2
    esrgan_epochs: int = 1
    # pipeline's ESRGAN keeps JAX's dense attention: at LR 128^2 x4 its
    # upsample attention holds a 65,536^2 f32 score map (17.2 GB) and its
    # softmax per image, so two images a batch fit the card, not 16
    pipeline_batch: int = 2
    task: str = "hard"
    train_seed: int = 700        # the sets' draws: --seed plus these
    pred_seed: int = 800


def write_reference_dataset(root: str, c: CommandsSlice, seed: int, dev,
                            maps: bool) -> None:
    """``c.images`` HR surfaces of ``c.size``^2 from ``seed`` and their x0.25
    degradations, written as ``preprocess`` writes them: HR/ and LR/ PNGs
    rounded to uint8, ``class_map.pkl`` (basename -> label) and, for a
    training set, ``interp_map.pkl`` (basename -> the INTER_* name drawn)."""
    import pickle

    from tpusr_torch.core import prng
    from tpusr_torch.data.degrade import DegradeConfig, degrade_image
    from tpusr_torch.pipeline.png import encode_png_u8
    from tpusr_torch.tools import serving_gate as sg

    task = sg.TASKS[c.task]
    k5_before = k5_launches()
    hr, labels = sg.make_surface_images(
        seed, c.images, c.size, amp_range=task["amp_range"],
        noise=task["noise"], coverage_range=task["coverage_range"], device=dev)
    key = prng.PRNGKey(seed)
    cfg = DegradeConfig(scale_factor=0.25)
    interp_map, class_map = {}, {}
    for sub in ("HR", "LR"):
        os.makedirs(os.path.join(root, sub))
    for i in range(c.images):
        key, k = prng.split(key)
        lr, interp = degrade_image(hr[i], k, cfg, apply_jpeg=False)
        name = f"sample_{i:05d}.png"
        for sub, img in (("HR", hr[i]), ("LR", lr)):
            u8 = (img * 255).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(encode_png_u8(u8))
        interp_map[name] = interp
        class_map[name] = int(labels[i])
    # the surfaces' 7 uniforms and noise, each image's degradation noise
    k5 = k5_launches() - k5_before
    check(k5 == 8 + c.images, f"the reference dataset: {k5} K5 launches, not "
                              f"{8 + c.images}")
    K5_BY_PATH["reference_datasets"] = K5_BY_PATH.get(
        "reference_datasets", 0) + k5
    with open(os.path.join(root, "class_map.pkl"), "wb") as f:
        pickle.dump(class_map, f)
    if maps:
        with open(os.path.join(root, "interp_map.pkl"), "wb") as f:
            pickle.dump(interp_map, f)


class split_sizes:
    """While open, record the sizes of every ``cli._split`` (train, val,
    test)."""

    def __enter__(self):
        from tpusr_torch.cli import __main__ as cli
        self.sizes = []
        self._p = patched(cli, _split=lambda orig: lambda x, y: self._rec(
            orig(x, y)))
        self._p.__enter__()
        return self

    def _rec(self, parts):
        self.sizes.append(tuple(len(parts[i]) for i in (0, 2, 4)))
        return parts

    def __exit__(self, *exc):
        self._p.__exit__(*exc)


class first_train_step:
    """While open, keep the trainer, a copy of the weights and the batch of
    the first train step of a ``SupervisedSRTrainer`` or ``ESRGANTrainer``,
    copied before the step updates the weights in place: ``got`` = (trainer,
    {state field: {name: tensor}}, x, y)."""

    def __enter__(self):
        from tpusr_torch.train import gan
        from tpusr_torch.train import trainer as tr
        self.got = None

        def keep(fields):
            def wrap(orig):
                def step(trainer, state, x, y, *a, **kw):
                    if self.got is None:
                        self.got = (trainer, {
                            f: {k: v.detach().clone().requires_grad_(
                                v.requires_grad and f in ("params", "g_params"))
                                for k, v in getattr(state, f).items()}
                            for f in fields}, x.clone(), y.clone())
                    return orig(trainer, state, x, y, *a, **kw)
                return step
            return wrap
        self._p = [patched(tr.SupervisedSRTrainer,
                           _train_step_w=keep(("params",))),
                   patched(gan.ESRGANTrainer, train_step=keep(
                       ("g_params", "d_params", "d_spectral")))]
        for p in self._p:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in self._p:
            p.__exit__(*exc)


def command_step_against_twin(tag: str, layers: list, params: dict, forward,
                              loss) -> str:
    """A train command's step at its own shapes, on the weights and the
    batch of its first step: each K2 launch of the forward (``forward()``)
    against the twin on its own input within ``k2_forward_bound``
    (``k2_against_twin``), then each conv of ``layers`` ((name, shape,
    relu) in forward order) on the x and dY that the backward of
    ``loss()`` over ``params`` gives it: dX of the K2 Function within
    ``k2_f32_bound`` of autograd through the twin, dW and db within
    ``GRAD_RTOL`` (``k2_backward_case``)."""
    want = [(shape, relu) for _, shape, relu in layers]
    with torch.no_grad(), k2_against_twin() as k2c:
        forward()
    check([(r[0], r[1]) for r in k2c.rows] == want,
          f"{tag}: the forward's K2 launches {[r[:2] for r in k2c.rows]} are "
          f"not the convs {want}")
    check(all(r[4] for r in k2c.rows),
          f"{tag}: K2 beyond its per-output bound against the twin at "
          f"{[r[0] for r in k2c.rows if not r[4]]}")
    with k2_train_io() as rec, torch.enable_grad():
        torch.autograd.grad(loss(), [p for p in params.values()
                                     if p.requires_grad])
    worst = recorded_backward_cases(tag, layers, rec.calls)
    del rec
    torch.cuda.empty_cache()
    return (f"its first step at its own shapes on K2 against the twin: the "
            f"{len(k2c.rows)} forward launches within their per-output bound "
            f"(largest err {max(r[2] for r in k2c.rows):.3g}, bound "
            f"{max(r[3] for r in k2c.rows):.3g}), the {len(layers) - 1} dX "
            f"within 2*9*C*2^-24*sum|dY||k| (largest share "
            f"{worst['dx_share']:.3f}), dW and db within {GRAD_RTOL} of their "
            f"max (worst {worst['dw']:.2g}, {worst['db']:.2g}), ReLU masks "
            f"differ at {worst['flips']} near-zero outputs")


def k2_command_launches(sizes, bs: int, epochs: int, train_step: int,
                        eval_step: int, gan: bool) -> int:
    """K2 launches of a train command: per epoch its train steps (the
    supervised trainer pads the trailing batch, the GAN trainer drops it)
    and the validation batches, then the test batches."""
    n_tr, n_va, n_te = sizes
    steps = max(1, n_tr // bs) if gan else -(-n_tr // bs)
    return (epochs * (steps * train_step + -(-n_va // bs) * eval_step)
            + -(-n_te // bs) * eval_step)


# The JAX commands' figure files (tpusr/cli/__main__.py:162-183 for
# classic, :463-500 for pipeline; tpusr/data/eda.py:519-565 for eda, whose
# scenario dumps add <file> and advanced_<file> under
# LPIPS_Scenarios/{best,worst}_scenarios for each pair it picks), written
# here because the card's machine has no JAX
CLASSIC_FIGURES = ("time_memory_summary.png", "psnr_ssim_summary.png",
                   "speed_quality_3d.png", "error_metrics.png",
                   "edge_metrics.png", "freq_dist_metrics.png",
                   "algorithm_ranking.png")
PIPELINE_FIGURES = ("cls_report_confusions.png", "cls_report_summary.png",
                    "sr_confidence_panel.png", "confusion_matrices.png",
                    "sr_metrics_panel.png", "sr_time_panel.png",
                    "sr_memory_panel.png")
EDA_FIGURES = ("advanced_global_panel.png", "distributions.png",
               "artifact_color_histograms.png", "artifact_boxplots.png",
               "channel_shape_bars.png", "correlation_matrix.png",
               "scatter_relations.png")
FIGURE_FUNCTIONS = {
    "tpusr_torch.viz": (
        "plot_time_memory_panels", "plot_psnr_ssim_panels",
        "plot_speed_quality_tradeoff_3d", "plot_error_metrics_grid",
        "plot_edge_metrics_grid", "plot_frequency_distribution_metrics_grid",
        "plot_and_save_super_resolution_example",
        "plot_and_save_ssim_similarity_maps", "show_algorithm_ranking",
        "plot_sr_metrics", "plot_sr_time", "plot_sr_memory", "plot_confusion",
        "plot_classification_reports_panel", "plot_4x3",
        "plot_confidence_panel"),
    "tpusr_torch.data.eda": (
        "save_visual_example", "create_advanced_visualizations",
        "artifact_color_histograms", "channel_shape_bars",
        "create_global_advanced_visualizations", "basic_distributions",
        "artifact_boxplots", "correlation_matrix", "scatter_relations")}


def all_launches() -> dict:
    """Every kernel's launch count: K1, K2 (f32, bf16), the dequant conv,
    K3 and K4."""
    from tpusr_torch.core import nlm
    return {**read_counts(), **nlm.LAUNCHES}


class figure_stage:
    """While open, every figure function of ``FIGURE_FUNCTIONS`` (called
    from outside another) and every ``Figure.savefig`` made outside them
    (the pipeline's inline confusion grid) is a step of the figure stage:
    timed between two synchronisations under a CUDA-only ``torch.profiler``
    (``rows``: name, ms, device ms, kernels), with the launches of every
    kernel counted across it (``launches``). ``figures`` keeps each saved
    Figure with its file."""

    def __init__(self, sync):
        self.sync, self.rows, self.figures = sync, [], []
        self.launches: dict = {}
        self._depth = 0

    def __enter__(self):
        import importlib

        from tpusr_torch.viz import figure as vf
        self._undo = []
        for modname, names in FIGURE_FUNCTIONS.items():
            mod = importlib.import_module(modname)
            for n in names:
                self._undo.append((mod, n, getattr(mod, n)))
                setattr(mod, n, self._step(n, getattr(mod, n)))
        save = vf.Figure.savefig
        stage = self

        def savefig(fig, fname, dpi=None, **kw):
            def run():
                return save(fig, fname, dpi=dpi, **kw)
            out = (run() if stage._depth else
                   stage._step(f"savefig {os.path.basename(str(fname))}", run)())
            stage.figures.append((fig, str(fname)))
            return out
        self._undo.append((vf.Figure, "savefig", save))
        vf.Figure.savefig = savefig
        return self

    def __exit__(self, *exc):
        for mod, n, orig in reversed(self._undo):
            setattr(mod, n, orig)

    def _step(self, name, fn):
        def run(*a, **kw):
            if self._depth:
                return fn(*a, **kw)
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            self._depth += 1
            try:
                self.sync()
                before = all_launches()
                acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                        else [ProfilerActivity.CPU])    # a CPU rehearsal
                with profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    self.sync()
                    ms = (time.perf_counter() - t0) * 1e3
                after = all_launches()
            finally:
                self._depth -= 1
            for k, v in after.items():
                self.launches[k] = self.launches.get(k, 0) + v - before.get(k, 0)
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            self.rows.append((name, ms, sum(e.self_device_time_total
                                            for e in kern) / 1e3,
                              sum(e.count for e in kern)))
            return out
        return run

    def total_ms(self) -> float:
        return sum(r[1] for r in self.rows)

    def device_ms(self) -> float:
        return sum(r[2] for r in self.rows)


def axes_has_data(ax) -> bool:
    """Whether an Axes drew a finite value: a bar, a histogram count, an
    image, a point or a line."""
    for c in ax.calls:
        if c.name == "imshow":
            return True
        if c.name in ("bar", "barh", "scatter", "plot", "hist", "boxplot"):
            vals = (c.out["counts"] if c.name == "hist" else
                    [s["med"] for s in c.out["stats"]] if c.name == "boxplot"
                    else c.args[1])
            v = vals.detach().cpu().numpy() if isinstance(
                vals, torch.Tensor) else vals
            if np.isfinite(np.asarray(v, np.float64)).any():
                return True
    return False


def decode_figure(path: str) -> np.ndarray:
    from tpusr_torch.pipeline.jpeg import decode_jpeg_u8
    from tpusr_torch.pipeline.png import decode_png_u8
    with open(path, "rb") as f:
        body = f.read()
    return (decode_jpeg_u8 if path.lower().endswith((".jpg", ".jpeg"))
            else decode_png_u8)(body)


def image_panel_against_host(fig, img: np.ndarray) -> tuple[str, float, float]:
    """The first colormapped image panel of ``fig``: its data mapped through
    the colormap on the host (``rgba_numpy``) and nearest-resampled into its
    panel, against the panel's bytes from the device (the share equal, which
    must be 1) and against the file's pixels there (alpha on white; the
    share equal, 1 unless the figure writes text over the panel)."""
    from tpusr_torch.viz import colormaps
    from tpusr_torch.viz.render import nearest_index
    for i, ax in enumerate(fig.axes):
        for c in ax.calls:
            if c.name != "imshow":
                continue
            data = c.args[0]
            data = (data.detach().cpu().numpy() if isinstance(data, torch.Tensor)
                    else np.asarray(data))
            if data.ndim != 2:
                continue
            cm = colormaps.get_cmap(c.kwargs["cmap"] or "viridis")
            src = cm.rgba_numpy(data, c.kwargs["vmin"], c.kwargs["vmax"])
            y0, x0, h, w = c.out["panel"]
            want = src[nearest_index(src.shape[0], h)][:, nearest_index(
                src.shape[1], w)]
            dev_share = float((c.out["panel_rgba"] == want).all(-1).mean())
            a = want[..., 3:].astype(np.float64) / 255
            rgb = np.rint(want[..., :3] * a + 255 * (1 - a)).astype(np.uint8)
            file_share = float((img[y0:y0 + h, x0:x0 + w] == rgb).all(-1).mean())
            texts = any(t.name == "text" for t in ax.calls)
            check(dev_share == 1.0, f"image panel {i} ({cm.name}): the device's "
                                    f"bytes differ from the host's mapping "
                                    f"({dev_share:.6f} equal)")
            check(file_share == 1.0 or (texts and file_share >= 0.8),
                  f"image panel {i} ({cm.name}): {file_share:.6f} of its "
                  f"pixels equal the host's mapping")
            return f"axes {i} {cm.name} {h}x{w}", dev_share, file_share
    return "", math.nan, math.nan


def check_figures(tag: str, stage: figure_stage, out_dir: str, want: list,
                  card: str) -> dict:
    """The figure files under ``out_dir`` are the JAX command's ``want``;
    each decodes with the port's own decoder at figsize x dpi; no axes
    region is blank; one image panel equals its data mapped on the host;
    no kernel was launched by the figure stage. Prints the stage's and each
    figure's ms, the files' bytes and the device's share."""
    files = sorted(os.path.relpath(os.path.join(r, f), out_dir)
                   for r, _, fs in os.walk(out_dir) for f in fs
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    check(files == sorted(want), f"{tag}: figure files {files}, the JAX "
                                 f"command writes {sorted(want)}")
    check(sorted(os.path.relpath(f, out_dir) for _, f in stage.figures)
          == sorted(want), f"{tag}: figures saved {len(stage.figures)}")
    sizes, panel = [], None
    for fig, path in stage.figures:
        img = decode_figure(path)
        (_, dpi, nbytes), = [s for s in fig.saved if s[0] == path]
        shape = (round(fig.figsize[1] * dpi), round(fig.figsize[0] * dpi), 3)
        check(img.shape == shape, f"{tag}: {path} decodes to {img.shape}, "
                                  f"figsize x dpi is {shape}")
        for i, (ax, (x0, y0, x1, y1)) in enumerate(zip(fig.axes, fig.boxes)):
            if all(c.name == "axis" for c in ax.calls):
                continue            # a grid cell the figure leaves empty
            # inside the frame where the axes holds finite data (JAX's
            # figure too is empty there where every value is NaN), else
            # the frame with its title and ticks
            pad = 0 if axes_has_data(ax) else 3
            region = img[max(y0 - pad, 0):y1 + pad, max(x0 - pad, 0):x1 + pad]
            check(region.size > 0 and bool((region < 250).any()),
                  f"{tag}: {os.path.basename(path)} axes {i} is blank")
        if panel is None and path.lower().endswith(".png"):
            where, dev_share, file_share = image_panel_against_host(fig, img)
            if where:
                panel = (os.path.relpath(path, out_dir), where, dev_share,
                         file_share)
        sizes.append((os.path.relpath(path, out_dir), shape[1], shape[0],
                      nbytes))
    launched = {k: v for k, v in stage.launches.items() if v}
    check(not launched, f"{tag}: the figure stage launched {launched}")
    total, busy = stage.total_ms(), stage.device_ms()
    kernels = sum(r[3] for r in stage.rows)
    print(f"[figures] {card}: {tag}: {len(stage.figures)} figures (the JAX "
          f"command's files) in {total:.1f} ms (CUDA-only torch.profiler on; "
          f"host clock, synchronised per figure), device busy {busy:.2f} ms "
          f"= {100 * busy / total:.2f}% of the stage in {kernels} kernel "
          f"launches (torch ops; K1-K4 and the dequant conv 0); per step: "
          + "; ".join(f"{n} {ms:.1f} ms (device {d:.2f})"
                      for n, ms, d, _ in stage.rows))
    print(f"[figures] {tag}: files " + "; ".join(
        f"{n} {w}x{h} {b} B" for n, w, h, b in sizes))
    if panel is not None:
        print(f"[figures] {tag}: {panel[0]} {panel[1]}: the device's bytes "
              f"equal the host's colormap of its data in {panel[2]:.6f} of "
              f"the panel, the file's pixels in {panel[3]:.6f}")
    check(panel is not None, f"{tag}: no colormapped image panel in a PNG "
                             f"figure")
    return {"ms": total, "device_ms": busy, "figures": len(stage.figures),
            "bytes": sum(s[3] for s in sizes),
            "steps": [(n, ms, d) for n, ms, d, _ in stage.rows]}


def phase_commands(c: CommandsSlice, dev, seed: int, sync, card: str) -> dict:
    """The reference's commands through ``tpusr_torch.cli.__main__.main``, in
    process so that launches count: ``train-edsr`` (x4), ``train-srcnn``,
    ``train-vgg16``, ``train-esrgan`` (x4), ``classic`` and ``pipeline`` on
    the four checkpoints they wrote. Each command is driven with the launch
    counts set to 0 just before it and read just after. Returns the K2 and
    K4 launches of each command."""
    import shutil
    import tempfile

    from tpusr_torch.cli.__main__ import main as cli_main
    from tpusr_torch.config import EDSRConfig, ESRGANConfig, VGG16Config
    from tpusr_torch.core import nlm
    from tpusr_torch.pipeline import defect_pipeline
    from tpusr_torch.utils import assert_all_finite

    out = subprocess.run([sys.executable, "-m", "tpusr_torch.cli",
                          "train-edsr", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0 and "--hr-dir" in out.stdout,
          f"`python -m tpusr_torch.cli train-edsr --help`: {out.stderr[-300:]}")
    work = tempfile.mkdtemp(prefix="chip_smoke_commands_")
    try:
        t0 = time.perf_counter()
        data, pred = os.path.join(work, "data"), os.path.join(work, "pred")
        write_reference_dataset(data, c, seed + c.train_seed, dev, maps=True)
        write_reference_dataset(pred, c, seed + c.pred_seed, dev, maps=False)
        print(f"[commands] datasets: {c.images} + {c.images} HR {c.size}^2 / "
              f"LR {c.size // 4}^2 PNG pairs ({c.task} task surfaces, "
              f"degrade_image x0.25, no JPEG stage) in "
              f"{time.perf_counter() - t0:.1f} s")
        hr, lr = os.path.join(data, "HR"), os.path.join(data, "LR")
        ck = os.path.join(work, "ck")
        ed, es, vg = EDSRConfig(), ESRGANConfig(), VGG16Config()
        bs = 16      # the SR train commands' default --batch-size
        commands = {
            "train-edsr": ["--hr-dir", hr, "--lr-dir", lr, "--scale", "4",
                           "--epochs", str(c.edsr_epochs)],
            "train-srcnn": ["--hr-dir", hr, "--lr-dir", lr, "--interp-map",
                            os.path.join(data, "interp_map.pkl"),
                            "--epochs", str(c.srcnn_epochs)],
            "train-vgg16": ["--hr-dir", hr, "--class-map",
                            os.path.join(data, "class_map.pkl"),
                            "--epochs", str(c.vgg16_epochs)],
            "train-esrgan": ["--hr-dir", hr, "--lr-dir", lr, "--scale", "4",
                             "--epochs", str(c.esrgan_epochs)],
            "classic": ["--hr-dir", hr, "--lr-dir", lr, "--fraction", "1.0",
                        "--limit", str(c.images)],
            "pipeline": ["--lr-dir", os.path.join(pred, "LR"), "--hr-dir",
                         os.path.join(pred, "HR"), "--class-map",
                         os.path.join(pred, "class_map.pkl"), "--batch-size",
                         str(c.pipeline_batch)],
        }
        per_step = {   # (train step, eval step) K2 launches at x4
            "train-edsr": (2 * (2 * ed.num_res_blocks + 5) - 1,
                           2 * ed.num_res_blocks + 5),
            "train-esrgan": (2 * esrgan_launches(es.num_rrdb_blocks, 4) - 1,
                             esrgan_launches(es.num_rrdb_blocks, 4))}
        ckpt, launches, captured = {}, {}, {}

        def keep(orig):
            def run(sr_methods, *a, **kw):
                captured["sr"], captured["x_lr"] = sr_methods, a[1]
                return orig(sr_methods, *a, **kw)
            return run

        for name, args in commands.items():
            argv = [name, *args, "--out", os.path.join(ck if name.startswith(
                "train") else work, name)]
            if name == "pipeline":
                argv += ["--vgg16-ckpt", ckpt["train-vgg16"], "--srcnn-ckpt",
                         ckpt["train-srcnn"], "--edsr-ckpt",
                         ckpt["train-edsr"], "--esrgan-ckpt",
                         ckpt["train-esrgan"]]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            with (count_plain_calls() as plain, split_sizes() as sp,
                  first_train_step() as first, figure_stage(sync) as figs,
                  patched(defect_pipeline,
                          run_defect_detection_comparison=keep)):
                reset_counts()
                nlm.reset_launch_counts()
                n0 = INIT_K5["n"]
                t0 = time.perf_counter()
                ret = cli_main(argv)
                sync()
                wall = time.perf_counter() - t0
                got = read_counts()
                k4 = nlm.LAUNCHES["nlm_denoise"]
            peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
            check(plain.n == 0, f"{name}: plain twins on the card "
                                f"{plain.by_twin}")
            launches[name] = {"conv3x3_bias_act": got["conv3x3_bias_act"],
                              "nlm_denoise": k4}
            want_k2, want_k4, want_k5, extra = 0, 0, 0, ""
            if name.startswith("train"):
                path = ret
                ckpt[name] = path
                files = sorted(f for f in os.listdir(os.path.dirname(path)))
                base = os.path.basename(path)
                check(files == sorted(base + s for s in (
                    "", ".meta.json", ".metrics.csv", ".metrics.jsonl")),
                      f"{name}: wrote {files}")
                meta = json.load(open(path + ".meta.json"))
                check({"eval", "history", "epoch_time_sec", "memory",
                       "timestamp"} <= set(meta), f"{name}: meta {sorted(meta)}")
                (sizes,) = sp.sizes
                leaves = checkpoint_leaves(path)
                assert_all_finite(leaves, name)
                hist = meta["history"]
                epochs = len(hist.get("loss") or hist["g_loss"])
                gan = name == "train-esrgan"
                batch = vg.batch_size if name == "train-vgg16" else bs
                steps = epochs * (max(1, sizes[0] // batch) if gan
                                  else -(-sizes[0] // batch))
                fit_s = sum(meta["epoch_time_sec"])
                if name in per_step:
                    want_k2 = k2_command_launches(sizes, bs, epochs,
                                                  *per_step[name], gan)
                if name == "train-vgg16":     # two dropout masks a step
                    want_k5 = 2 * steps
                ev = meta["eval"]
                score = (f"accuracy {ev['accuracy']:.4f}" if "accuracy" in ev
                         else f"PSNR {ev.get('psnr', ev.get('avg_psnr')):.2f} "
                              f"dB")
                loss = ev.get("loss", ev.get("avg_g_loss"))
                check(math.isfinite(loss), f"{name}: eval loss {loss}")
                extra = (f"split {sizes[0]}/{sizes[1]}/{sizes[2]}, {epochs} "
                         f"epoch(s) in {fit_s:.1f} s, {steps} train steps "
                         f"({steps / fit_s:.1f} steps/s over the epochs' "
                         f"train and validation); eval loss {loss:.5f}, "
                         f"{score}; files {files}")
            elif name == "classic":
                res = json.load(open(os.path.join(work, name,
                                                  "classic_summary.json")))
                check(sorted(res) == ["ranked", "summary"]
                      and len(res["ranked"]) == 8, f"classic: {sorted(res)}")
                # per pair: the scored run, the warm-up and one timed call;
                # once per shape: the memory measurement (phase_classic)
                want_k4 = c.images * 3 + 1
                extra = (f"ranking {', '.join(a for a, _ in res['ranked'])}; "
                         f"bicubic PSNR {res['summary']['bicubic']['psnr_mean']:.2f}"
                         f" dB; files {sorted(os.listdir(os.path.join(work, name)))}")
            else:
                res = json.load(open(os.path.join(work, name,
                                                  "pipeline_results.json")))
                methods = ["bilinear", "bicubic", "area", "lanczos4", "srcnn",
                           "edsr", "esrgan"]
                check(list(res) == methods, f"pipeline: methods {list(res)}")
                for m, r in res.items():
                    check(0.0 <= r["accuracy"] <= 1.0
                          and math.isfinite(r["psnr_mean"])
                          and math.isfinite(r["mean_confidence"]),
                          f"pipeline {m}: {r}")
                    check(ret[m]["predictions"].shape == (c.images,),
                          f"pipeline {m}: predictions")
                calls = 1 + -(-c.images // c.pipeline_batch)   # + the warm-up
                want_k2 = calls * (2 * ed.num_res_blocks + 5
                                   + esrgan_launches(es.num_rrdb_blocks, 4))
                extra = ("; ".join(f"{m} acc {r['accuracy']:.4f} PSNR "
                                   f"{r['psnr_mean']:.2f} {r['time_sec']:.3f} s"
                                   for m, r in res.items())
                         + f"; files {sorted(os.listdir(os.path.join(work, name)))}")
            # and the command's model builds, each held to its drawn leaves
            built = init_since(n0)
            check(got == launches_want(conv3x3_bias_act=want_k2,
                                       prng=want_k5 + built),
                  f"{name}: launches {got}, expected {want_k2} K2, {want_k5} "
                  f"+ {built} (its model builds) K5 and no other")
            check(k4 == want_k4, f"{name}: K4 launches {k4} != {want_k4}")
            if want_k5:
                K5_BY_PATH[f"commands_{name.replace('-', '_')}"] = want_k5
            print(f"[commands] {card}: {name} in {wall:.1f} s: {extra}; K2 "
                  f"{got['conv3x3_bias_act']} launches, K2-bf16 "
                  f"{got['conv3x3_bias_act_bf16']}, K4 {k4}; peak "
                  f"{peak_mb:.1f} MB")
            if name in ("classic", "pipeline"):
                fig = check_figures(name, figs, os.path.join(work, name), list(
                    CLASSIC_FIGURES if name == "classic" else PIPELINE_FIGURES),
                    card)
                print(f"[figures] {name}: the command's K2 {want_k2} and K4 "
                      f"{want_k4} launches as before the figures (held "
                      f"above); its figure stage {fig['ms']:.1f} ms of its "
                      f"{wall * 1e3:.0f} ms")
            else:
                check(not figs.figures, f"{name}: drew {len(figs.figures)} "
                                        f"figures")
            if name in per_step:
                tr, w, x, y = first.got
                n, lr_side = x.shape[0], x.shape[1]
                check(tuple(y.shape[1:3]) == (4 * lr_side, 4 * lr_side),
                      f"{name}: first batch {tuple(x.shape)} -> "
                      f"{tuple(y.shape)}")
                if name == "train-edsr":
                    p = w["params"]
                    line = command_step_against_twin(
                        name, edsr_train_layers(TrainSlice(
                            lr=lr_side, batch=n, blocks=ed.num_res_blocks,
                            filters=ed.num_filters)), p,
                        lambda: tr._apply(p, x),
                        lambda: tr._loss(p, x, y, tr._ones_weights(n), 0)[0])
                else:
                    p = w["g_params"]
                    line = command_step_against_twin(
                        name, gan_train_layers(GanSlice(
                            lr=lr_side, scale=4, batch=n),
                            es.growth_channels, es.num_rrdb_blocks), p,
                        lambda: tr._generate(p, x),
                        lambda: tr.g_loss_components(
                            p, w["d_params"], w["d_spectral"], x, y)[0])
                print(f"[commands] {name} (batch {n} of LR {lr_side}^2 -> HR "
                      f"{4 * lr_side}^2): {line}")
                del first.got, tr, w, x, y, p

        # pipeline's EDSR SR of its first batch against the same SR on K2's
        # twin: every launch within its per-output bound on its own input,
        # the output at SR_ATOL (as the served f32 SR)
        x = torch.as_tensor(captured["x_lr"][:c.pipeline_batch], device=dev)
        edsr_sr = captured["sr"]["edsr"]
        with torch.inference_mode():
            out = edsr_sr(x)
            with models_on_k2_twin():
                ref = edsr_sr(x)
            with k2_against_twin() as k2c:
                edsr_sr(x)
        err = float((out - ref).abs().max())
        check(len(k2c.rows) == 2 * ed.num_res_blocks + 5
              and all(r[4] for r in k2c.rows),
              f"pipeline EDSR: K2 beyond its bound against the twin at "
              f"{[r[0] for r in k2c.rows if not r[4]]}")
        check(err <= SR_ATOL, f"pipeline EDSR: against the twin max|err| "
                              f"{err} > {SR_ATOL}")
        print(f"[commands] pipeline's EDSR SR of its first batch "
              f"{tuple(out.shape)}: every one of its {len(k2c.rows)} K2 "
              f"launches within its per-output bound against the twin "
              f"(largest err {max(r[2] for r in k2c.rows):.3g}, bound "
              f"{max(r[3] for r in k2c.rows):.3g}); the SR against the same "
              f"SR on the twin max|err| {err:.3g} (SR_ATOL {SR_ATOL})")

        # its ESRGAN SR (x4, dense attention) of the same batch, held as
        # phase_inference holds the x2 generator's full-image SR
        esr_sr, n_esr = captured["sr"]["esrgan"], esrgan_launches(
            es.num_rrdb_blocks, 4)
        with torch.inference_mode():
            out = esr_sr(x)
            with models_on_k2_twin():
                ref = esr_sr(x)
            with k2_against_twin() as k2c:
                esr_sr(x)
        err = float((out - ref).abs().max())
        # K2's per-conv tolerance at each launch carried to the output to
        # first order with gain 1, halved by the [-1, 1] -> [0, 1] map
        tol = 0.5 * n_esr * K2_ATOL
        check(len(k2c.rows) == n_esr and all(r[4] for r in k2c.rows),
              f"pipeline ESRGAN: {len(k2c.rows)} launches, K2 beyond its "
              f"bound against the twin at "
              f"{[r[0] for r in k2c.rows if not r[4]]}")
        check(err <= tol, f"pipeline ESRGAN: against the twin max|err| {err} "
                          f"> {tol}")
        print(f"[commands] pipeline's ESRGAN SR of its first batch "
              f"{tuple(out.shape)}: every one of its {len(k2c.rows)} K2 "
              f"launches within its per-output bound against the twin "
              f"(largest err {max(r[2] for r in k2c.rows):.3g}, bound "
              f"{max(r[3] for r in k2c.rows):.3g}); the SR against the same "
              f"SR on the twin max|err| {err:.3g} (tolerance {tol:.3g}, "
              f"derived: 1/2 x {n_esr} launches x K2_ATOL)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# --------------------------------------------------------------------- dist

@dataclass(frozen=True)
class DistSlice:
    """The parallelism layer (``tpusr_torch/dist``) at full width on one
    card: NCCL at world size 1 for every path (the data-parallel trainers at
    ``TrainSlice``'s and ``GanSlice``'s shapes, the shipped serving mode on
    the gate's trained weights at batch 16 with 3 pad rows, full-image SR
    of ESRGAN g8 x4 at 128^2 with its rows split and the ring, the PP train
    step of EDSR x4 with 16 blocks in 1 stage at 4 microbatches), then 2
    gloo ranks sharing the card for what gloo carries on CUDA tensors."""
    dp_steps: int = 20
    vgg_steps: int = 3
    gan_steps: int = 3
    n_valid: int = 13
    pp_micro: int = 4
    sp_lr: int = 128
    sp_scale: int = 4
    ranks: int = 2


# gloo's collectives that take CUDA tensors on the card (a probe run on the
# H100: all_reduce, broadcast, all_gather, all_gather_into_tensor,
# reduce_scatter_tensor, all_to_all_single); send/recv and
# batch_isend_irecv are refused ("Bad address")
GLOO_CUDA_CARRIES = ("all_reduce", "broadcast", "all_gather")
GLOO_CPU_ONLY = ("PP (pipeline hops: batch_isend_irecv)",
                 "SP (halo exchanges and the ring: batch_isend_irecv)")


def hold_train_calls(tag: str, calls: list) -> dict:
    """Every distinct (shape, relu) of the K2 training convs ``k2_train_io``
    recorded: the forward against the twin within ``k2_forward_bound``, and
    dX, dW, db by ``k2_backward_case`` (no dX where Cin is 3: the data).
    Returns the worst shares with the shapes held."""
    from tpusr_torch.core.conv3x3 import (conv3x3_bias_act,
                                          conv3x3_bias_act_plain)
    worst, seen = new_worst(), {}
    worst["fwd_err"] = 0.0
    for x, kernel, bias, relu, dy in calls:
        key = ((*x.shape, kernel.shape[-1]), relu)
        if key in seen or dy is None:
            continue
        seen[key] = True
        with torch.no_grad():
            y = conv3x3_bias_act(x.contiguous(), kernel, bias, relu)
            err = (y - conv3x3_bias_act_plain(x, kernel, bias, relu)).abs()
            bnd = k2_forward_bound(x, kernel, bias)
        check(bool((err.double() <= bnd).all()),
              f"{tag}: K2 forward at {key} beyond k2_forward_bound")
        worst["fwd_err"] = max(worst["fwd_err"], float(err.max()))
        k2_backward_case(f"{tag} {key}", x, dy, kernel, bias, relu,
                         key[0][3] != 3, worst)
    worst["shapes"] = sorted(seen)
    return worst


def dist_gloo_rank(rank: int, world: int, init_file: str, out_dir: str,
                   spec: dict) -> None:
    """One of ``DistSlice.ranks`` processes sharing card 0 over gloo: the DP
    EDSR x4 step (loss, every gradient leaf), the shipped mode served DP on
    the gate's weights, and TP on a (1, 2) mesh (EDSR x4 forward and one
    step), each against the same call unsharded on this rank, with the main
    runs' launch counts and plain-twin calls, and every new-shape K2 launch
    held against the twin."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from tpusr_torch.dist import make_mesh, make_tp_mesh, shard_params_tp
    from tpusr_torch.dist.tp import tp_apply
    from tpusr_torch.models import EDSR, VGG16Classifier
    from tpusr_torch.pipeline import make_serving_pipeline
    from tpusr_torch.train import SupervisedSRTrainer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    out = {"counts": {}, "plain": {}}
    try:
        mesh = make_mesh(device=dev)
        t = TrainSlice()
        g = torch.Generator(device=dev).manual_seed(spec["seed"] + 20)
        lr, hr = sr_pairs(g, t.batch, t, dev)

        def edsr():
            return EDSR(scale_factor=t.scale, num_res_blocks=t.blocks,
                        num_filters=t.filters, device=dev,
                        key=spec["seed"])

        def counted(name, fn):
            with count_plain_calls() as plain:
                reset_counts()
                res = fn()
                torch.cuda.synchronize()
                out["counts"][name] = read_counts()
            out["plain"][name] = plain.n
            return res

        # DP EDSR x4: the loss and every gradient leaf (the model built
        # before the counted step)
        def grads(m, count=False):
            tr = SupervisedSRTrainer(edsr(), learning_rate=1e-4, mesh=m,
                                     device=dev)
            st = tr.init_state()

            def run():
                return tr.value_and_grad(st, lr, hr)
            loss, _, gr = counted("dp_step", run) if count else run()
            return float(loss), gr
        loss_dp, g_dp = grads(mesh, count=True)
        loss_1, g_1 = grads(None)
        out["dp"] = {"loss": loss_dp, "loss_single": loss_1,
                     "grad_share": max(
                         float((g_dp[k] - g_1[k]).abs().max()
                               / g_1[k].abs().max().clamp_min(1e-30))
                         for k in g_1)}
        del g_dp, g_1

        # the shipped mode, DP, on the gate's trained weights
        weights = torch.load(spec["weights"], map_location=dev)
        cfg = Slice()
        sr_model = EDSR(scale_factor=cfg.scale, device=dev)
        sr_model.load_state_dict(weights["edsr"])
        clf = VGG16Classifier(num_classes=2, device=dev)
        clf.load_state_dict(weights["clf"])
        served = {}
        for name, m in (("dp_serve", mesh), ("single", None)):
            pipe = make_serving_pipeline(
                sr_model, clf, lr_hw=(cfg.lr, cfg.lr), scale=cfg.scale,
                patch=cfg.patch, stride=cfg.stride, sr_mode="f32",
                clf_mode="cascade_int8", calib_patches=weights["calib"],
                cascade_escalate_frac=cfg.frac,
                cascade_escalate_score="vote_frac",
                cascade_guard_threshold=cfg.guard, mesh=m, device=dev)
            run = (lambda p=pipe: p(weights["lr"], n_valid=spec["n_valid"]))
            _, cls, _ = counted(name, run) if m is not None else run()
            served[name] = cls.cpu().tolist()
            served[name + "_trips"] = pipe.cascade_votes.guard_trips
        out["served"] = served
        del weights

        # TP on (1, 2): EDSR x4 forward and one train step
        tp_mesh = make_tp_mesh(1, world, device=dev)
        model = edsr()
        params = shard_params_tp(tp_mesh, dict(model.named_parameters()))
        with torch.no_grad():
            y_tp = counted("tp_forward",
                           lambda: tp_apply(tp_mesh, model, params, lr))
            y_1 = model(lr)
            with k2_against_twin() as k2c:
                tp_apply(tp_mesh, model, params, lr)
        out["tp_forward"] = {"err": float((y_tp - y_1).abs().max()),
                             "launches_held": len(k2c.rows),
                             "all_within": all(r[4] for r in k2c.rows),
                             "shapes": sorted({(r[0], r[1]) for r in k2c.rows}),
                             "worst_share": max(r[2] / r[3] for r in k2c.rows
                                                if r[3] > 0)}

        def tp_step(m):
            tr = SupervisedSRTrainer(edsr(), learning_rate=1e-4, mesh=m,
                                     device=dev)
            st = tr.init_state()
            if m is not None:
                st = shard_params_tp(m, st)
            return float(tr.train_step(st, lr, hr)[1]["loss"])
        out["tp_step"] = {"loss": counted("tp_step", lambda: tp_step(tp_mesh)),
                          "loss_single": tp_step(None)}
        with k2_train_io() as io:
            tp_step(tp_mesh)
        out["tp_backward"] = hold_train_calls("tp", io.calls)
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gloo_ranks_on_card(d: DistSlice, cfg: Slice, trained: dict, dev,
                       seed: int, card: str) -> dict:
    """``dist_gloo_rank`` on ``d.ranks`` processes sharing card 0; they load
    the kernels ``phase_build`` built and build none."""
    import tempfile

    from tpusr_torch.dist.bootstrap import spawn

    work = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    try:
        lr = trained["lr_eval"][:cfg.batch].contiguous()
        with torch.no_grad():
            sr = trained["edsr"](lr[:2])
        calib = sr[:, :cfg.patch, :cfg.patch].contiguous()
        path = os.path.join(work, "weights.pt")
        torch.save({"edsr": trained["edsr"].state_dict(),
                    "clf": trained["clf"].state_dict(), "lr": lr,
                    "calib": calib}, path)
        t0 = time.perf_counter()
        spawn(dist_gloo_rank, d.ranks, (d.ranks, os.path.join(work, "init"),
                                        work, {"seed": seed, "weights": path,
                                               "n_valid": d.n_valid}))
        res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
               for r in range(d.ranks)]
        wall = time.perf_counter() - t0
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    t = TrainSlice()
    n_fwd = len(edsr_train_layers(t))
    for r, o in enumerate(res):
        tag = f"[dist-gloo rank {r}/{d.ranks}]"
        dp = o["dp"]
        check(abs(dp["loss"] - dp["loss_single"]) <= 1e-5 * dp["loss_single"],
              f"{tag} DP loss {dp['loss']} != single {dp['loss_single']}")
        check(dp["grad_share"] <= GRAD_RTOL, f"{tag} DP gradient differs from "
              f"the single-rank one by {dp['grad_share']:.3g} of its max")
        check(o["served"]["dp_serve"] == o["served"]["single"],
              f"{tag} DP served classes {o['served']}")
        check(o["served"]["dp_serve_trips"] == o["served"]["single_trips"],
              f"{tag} guard trips differ")
        tf = o["tp_forward"]
        check(tf["all_within"], f"{tag} a TP K2 launch beyond its bound")
        check(tf["err"] <= SR_ATOL, f"{tag} TP forward max|err| {tf['err']}")
        ts = o["tp_step"]
        check(abs(ts["loss"] - ts["loss_single"]) <= 1e-4,
              f"{tag} TP step loss {ts['loss']} != {ts['loss_single']}")
        check(all(v == 0 for v in o["plain"].values()),
              f"{tag} plain twins called on the card: {o['plain']}")
        want_dp = launches_want(conv3x3_bias_act=2 * n_fwd - 1)
        check(o["counts"]["dp_step"] == want_dp,
              f"{tag} DP step launches {o['counts']['dp_step']}")
        check(o["counts"]["tp_forward"]["conv3x3_bias_act"] == n_fwd,
              f"{tag} TP forward launches {o['counts']['tp_forward']}")
        print(f"{tag} {card}: DP EDSR x{t.scale} step at batch {t.batch} "
              f"({t.batch // d.ranks} rows a rank): loss {dp['loss']:.6f} vs "
              f"{dp['loss_single']:.6f} unsharded, gradients within "
              f"{dp['grad_share']:.2g} of their max (tolerance {GRAD_RTOL}); "
              f"the shipped mode DP at batch {cfg.batch}, n_valid "
              f"{d.n_valid}: classes {o['served']['dp_serve']} == unsharded, "
              f"guard trips {o['served']['dp_serve_trips']}; TP (1, "
              f"{d.ranks}) EDSR forward max|err| {tf['err']:.3g} (SR_ATOL "
              f"{SR_ATOL}), {tf['launches_held']} K2 launches held within "
              f"k2_forward_bound (worst share {tf['worst_share']:.3g}), TP step "
              f"loss {ts['loss']:.6f} vs {ts['loss_single']:.6f}; backward at "
              f"{len(o['tp_backward']['shapes'])} TP shapes: dX share "
              f"{o['tp_backward']['dx_share']:.3g}, dW {o['tp_backward']['dw']:.2g}"
              f", db {o['tp_backward']['db']:.2g}; launches {o['counts']}; "
              f"peak {o['peak_gb']:.2f} GB")
    print(f"[dist-gloo] {d.ranks} gloo ranks sharing card 0 carried "
          f"{', '.join(GLOO_CUDA_CARRIES)} on CUDA tensors; run on CPU ranks "
          f"in the tests only (tests/test_torch_dist_pp.py, "
          f"test_torch_dist_spatial.py): {'; '.join(GLOO_CPU_ONLY)}; wall "
          f"{wall:.1f} s with the ranks' start")
    return {"counts": res[0]["counts"], "tp_shapes": res[0]["tp_forward"]["shapes"],
            "tp_backward": res[0]["tp_backward"]}


def phase_dist(d: DistSlice, cfg: Slice, dev, seed: int, sync, card: str,
               trained: dict, train_step_ms: float) -> dict:
    """The parallelism layer on the card: NCCL at world size 1 for every
    path, then ``gloo_ranks_on_card``; every new K2 shape (the PP
    microbatch, the halo slabs, TP's Cout 32) held against the twin and
    timed beside ``F.conv2d``."""
    import torch.distributed as dist

    from tpusr_torch.dist import (make_mesh, make_pp_mesh, make_pp_train_step)
    from tpusr_torch.models import (EDSR, ESRGANDiscriminator, ESRGANGenerator,
                                    VGG16Classifier, VGG19Features)
    from tpusr_torch.pipeline import make_serving_pipeline
    from tpusr_torch.pipeline.inference import super_resolve_full_image
    from tpusr_torch.train import (ClassifierTrainer, ESRGANTrainer,
                                   SupervisedSRTrainer)

    t, gs = TrainSlice(), GanSlice()
    t0 = time.perf_counter()
    mesh = make_mesh(device=dev)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"mesh on {dist.get_backend()} at world {dist.get_world_size()}")
    launches, out = {}, {}
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    pool_lr, pool_hr = sr_pairs(g, t.pool, t, dev)
    sel = torch.randint(0, t.pool, (d.dp_steps, t.batch), generator=g,
                        device=dev)
    n_fwd = len(edsr_train_layers(t))

    def edsr():
        return EDSR(scale_factor=t.scale, num_res_blocks=t.blocks,
                    num_filters=t.filters, device=dev,
                    key=seed)

    with count_plain_calls() as plain:
        # ---- DP EDSR x4: 20 steps, the first against the unsharded step
        dp = SupervisedSRTrainer(edsr(), learning_rate=1e-4, mesh=mesh,
                                 device=dev)
        single = SupervisedSRTrainer(edsr(), learning_rate=1e-4, device=dev)
        loss_dp, _, g_dp = dp.value_and_grad(dp.init_state(), pool_lr[sel[0]],
                                             pool_hr[sel[0]])
        loss_1, _, g_1 = single.value_and_grad(single.init_state(),
                                               pool_lr[sel[0]], pool_hr[sel[0]])
        share = max(float((g_dp[k] - g_1[k]).abs().max()
                          / g_1[k].abs().max().clamp_min(1e-30)) for k in g_1)
        check(abs(float(loss_dp) - float(loss_1)) <= 1e-5 * float(loss_1)
              and share <= GRAD_RTOL, f"DP step vs unsharded: loss "
              f"{float(loss_dp)} vs {float(loss_1)}, gradient share {share}")
        del g_dp, g_1
        state = dp.init_state()
        reset_counts()

        def step(i):
            nonlocal state
            state, m = dp.train_step(state, pool_lr[sel[i]], pool_hr[sel[i]])
            return m["loss"]
        losses, ms = timed_steps(step, d.dp_steps)
        launches["dist_train"] = read_counts()
        check(launches["dist_train"] == launches_want(
            conv3x3_bias_act=d.dp_steps * (2 * n_fwd - 1)),
              f"DP EDSR launches {launches['dist_train']}")
        losses = [float(v) for v in losses]
        check(all(math.isfinite(v) for v in losses) and
              np.mean(losses[-5:]) < losses[0], f"DP EDSR losses {losses}")
        dp_ms = float(np.median(ms))
        # the same steps unsharded, right after: the mesh's cost on one card
        st1 = single.init_state()
        _, ms1 = timed_steps(lambda i: single.train_step(
            st1, pool_lr[sel[i]], pool_hr[sel[i]])[1]["loss"], d.dp_steps)
        one_ms = float(np.median(ms1))
        out.update(dp_step_ms=dp_ms, unsharded_step_ms=one_ms)
        del state, dp, single, st1
        print(f"[dist] {card}: NCCL world 1: DP EDSR x{t.scale} step median "
              f"{dp_ms:.3f} ms (CUDA events, {d.dp_steps} steps), the same "
              f"steps unsharded right after {one_ms:.3f} ms ({dp_ms - one_ms:+.3f}"
              f" ms: the mesh's cost on one card), phase_train's "
              f"{train_step_ms:.3f} ms; first step loss "
              f"{float(loss_dp):.6f} == unsharded {float(loss_1):.6f}, "
              f"gradients within {share:.2g} of their max; {2 * n_fwd - 1} K2 "
              f"launches a step")

        # ---- DP VGG16 with dropout, batch 64
        clf_x = smooth_images(g, t.vgg_batch, t.vgg_patch, 3, dev) / 255.0
        clf_y = (clf_x.mean(dim=(1, 2, 3)) > clf_x.mean()).to(torch.int32)

        def vgg_losses(m):
            tr = ClassifierTrainer(VGG16Classifier(
                num_classes=2, device=dev,
                key=seed + 1),
                learning_rate=2e-4, mesh=m, device=dev)
            st = tr.init_state()
            return [float(tr.train_step(st, clf_x, clf_y, i)[1]["loss"])
                    for i in range(d.vgg_steps)]
        # cuDNN's default backward convs may sum in another order on each
        # run, which three Adam steps carry past the tolerance
        k5_before, n0 = k5_launches(), INIT_K5["n"]
        with deterministic_cudnn():
            vl_dp, vl_1 = vgg_losses(mesh), vgg_losses(None)
        K5_BY_PATH["dist_vgg16"] = k5_launches() - k5_before - init_since(n0)
        check(K5_BY_PATH["dist_vgg16"] == 2 * 2 * d.vgg_steps
              and init_since(n0) == 2 * leaves_of("VGG16Classifier",
                                                  num_classes=2),
              f"DP and unsharded VGG16: {K5_BY_PATH['dist_vgg16']} K5 "
              f"launches, not two dropout masks a step, and "
              f"{init_since(n0)} for the two builds")
        check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(vl_dp, vl_1)),
              f"DP VGG16 losses {vl_dp} vs {vl_1}")
        print(f"[dist] {card}: DP VGG16 {d.vgg_steps} steps at batch "
              f"{t.vgg_batch} with dropout (deterministic cuDNN): losses "
              f"{vl_dp} == unsharded {vl_1}, max|difference| "
              f"{max(abs(a - b) for a, b in zip(vl_dp, vl_1)):.3g}")

        # ---- DP GAN at GanSlice's shapes
        gp_lr, gp_hr = sr_pairs(g, gs.batch, gs, dev)
        gp_lr, gp_hr = gp_lr * 2 - 1, gp_hr * 2 - 1

        def gan(m):
            def gen(k):
                return seed * 100 + 60 + k
            tr = ESRGANTrainer(
                ESRGANGenerator(gs.scale, gs.growth, gs.rrdb, device=dev,
                                key=gen(1)),
                ESRGANDiscriminator(device=dev, key=gen(2)),
                VGG19Features(device=dev, key=gen(3)), mesh=m,
                device=dev)
            st = tr.init_state()
            return [{k: float(v) for k, v in tr.train_step(st, gp_lr, gp_hr)[1]
                     .items()} for _ in range(d.gan_steps)]
        with deterministic_cudnn():
            reset_counts()
            gan_dp = gan(mesh)
            launches["dist_gan"] = read_counts()
            gan_1 = gan(None)
        per_gan = 2 * esrgan_launches(gs.rrdb, gs.scale) - 1
        # and the three models it builds
        built = (leaves_of("ESRGANGenerator", scale_factor=gs.scale,
                           growth_channels=gs.growth,
                           num_rrdb_blocks=gs.rrdb)
                 + leaves_of("ESRGANDiscriminator")
                 + leaves_of("VGG19Features"))
        check(launches["dist_gan"] == launches_want(
            conv3x3_bias_act=d.gan_steps * per_gan, prng=built),
              f"DP GAN launches {launches['dist_gan']}")
        for a, b in zip(gan_dp, gan_1):
            check(all(abs(a[k] - b[k]) <= 1e-5 * abs(b[k]) for k in b),
                  f"DP GAN step {a} vs {b}")
        print(f"[dist] {card}: DP GAN g{gs.growth}x{gs.rrdb} x{gs.scale} batch "
              f"{gs.batch}: {d.gan_steps} steps == unsharded (g_loss "
              f"{[round(v['g_loss'], 4) for v in gan_dp]}), {per_gan} K2 a step")

        # ---- the shipped mode DP on the gate's weights, 3 pad rows
        lr_b = trained["lr_eval"][:cfg.batch].contiguous()
        with torch.no_grad():
            sr2 = trained["edsr"](lr_b[:2])
        calib = sr2[:, :cfg.patch, :cfg.patch].contiguous()
        pipes = {name: make_serving_pipeline(
            trained["edsr"], trained["clf"], lr_hw=(cfg.lr, cfg.lr),
            scale=cfg.scale, patch=cfg.patch, stride=cfg.stride, sr_mode="f32",
            clf_mode="cascade_int8", calib_patches=calib,
            cascade_escalate_frac=cfg.frac, cascade_escalate_score="vote_frac",
            cascade_guard_threshold=cfg.guard, mesh=m, device=dev)
            for name, m in (("dp", mesh), ("single", None))}
        reset_counts()
        sr_dp, cls_dp, conf_dp = pipes["dp"](lr_b, n_valid=d.n_valid)
        sync()
        launches["dist_serve"] = read_counts()
        _, cls_1, conf_1 = pipes["single"](lr_b, n_valid=d.n_valid)
        check(torch.equal(cls_dp, cls_1) and float((conf_dp - conf_1).abs()
                                                   .max()) <= 1e-4,
              f"DP served classes {cls_dp.tolist()} vs {cls_1.tolist()}")
        check(launches["dist_serve"]["conv3x3_bias_act"] > 0
              and launches["dist_serve"]["conv3x3_int8_requant"] > 0,
              f"DP serving launches {launches['dist_serve']}")
        print(f"[dist] {card}: the shipped mode DP at batch {cfg.batch} "
              f"(n_valid {d.n_valid}) on the gate's weights: classes "
              f"{cls_dp.tolist()} == unsharded, guard trips "
              f"{pipes['dp'].cascade_votes.guard_trips}; launches "
              f"{launches['dist_serve']}")
        del pipes, sr_dp

        # ---- full-image SR, rows split (world 1: halo rows are zeros)
        gen = ESRGANGenerator(d.sp_scale, gs.growth, gs.rrdb, device=dev,
                              key=seed + 7)
        sp_img = smooth_images(g, 1, d.sp_lr, 3, dev)[0] / 255.0
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        sr_sp, met = super_resolve_full_image(gen, sp_img, mesh=mesh)
        launches["dist_full_image"] = read_counts()
        sp_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        n_esr = esrgan_launches(gs.rrdb, d.sp_scale)
        check(launches["dist_full_image"] == launches_want(
            conv3x3_bias_act=n_esr), f"SP launches {launches['dist_full_image']}")
        sr_blk, _ = super_resolve_full_image(gen, sp_img)
        sp_err = float(np.abs(sr_sp - sr_blk).max())
        tol = 0.5 * n_esr * K2_ATOL
        check(np.isfinite(sr_sp).all() and sp_err <= tol,
              f"SP full image vs blockwise: {sp_err} > {tol}")
        out["sp"] = {"ms": met["time_sec"] * 1e3, "peak_gb": sp_peak}
        print(f"[dist] {card}: full-image SR ESRGAN g{gs.growth}x{gs.rrdb} "
              f"x{d.sp_scale} at {d.sp_lr}^2 with the rows split (NCCL world "
              f"1, the ring at both attention sites): {n_esr} K2 launches on "
              f"halo slabs, {met['time_sec'] * 1e3:.1f} ms, peak "
              f"{sp_peak:.2f} GB; max|SR - blockwise SR| {sp_err:.3g} "
              f"(tolerance {tol:.3g}: 1/2 x launches x K2_ATOL)")

        # ---- PP: 16 blocks in 1 stage, 4 microbatches
        pp_model = edsr().trainable()
        pp_mesh = make_pp_mesh(1, device=dev)
        step = make_pp_train_step(pp_model, pp_mesh, n_micro=d.pp_micro,
                                  learning_rate=1e-4)
        params = {k: v.detach() for k, v in pp_model.named_parameters()}
        reset_counts()
        pp_loss, pp_g = step.value_and_grad(params, pool_lr[sel[0]],
                                            pool_hr[sel[0]])
        sync()
        launches["dist_pp"] = read_counts()
        dense = SupervisedSRTrainer(edsr(), learning_rate=1e-4, device=dev)
        d_loss, _, d_g = dense.value_and_grad(dense.init_state(),
                                              pool_lr[sel[0]], pool_hr[sel[0]])
        pp_share = max(float((pp_g[k] - d_g[k]).abs().max()
                             / d_g[k].abs().max().clamp_min(1e-30)) for k in d_g)
        check(abs(float(pp_loss) - float(d_loss)) <= 1e-5 * float(d_loss)
              and pp_share <= GRAD_RTOL, f"PP step vs dense: loss "
              f"{float(pp_loss)} vs {float(d_loss)}, gradient share {pp_share}")
        pp_ms = time_ms(lambda: step(params, pool_lr[sel[0]], pool_hr[sel[0]]),
                        min_total_ms=100.0, max_iters=5)
        print(f"[dist] {card}: PP EDSR x{t.scale} {t.blocks} blocks in 1 stage, "
              f"{d.pp_micro} microbatches of {t.batch // d.pp_micro}: loss "
              f"{float(pp_loss):.6f} == dense {float(d_loss):.6f}, gradients "
              f"within {pp_share:.2g} of their max; step {pp_ms:.2f} ms; "
              f"launches {launches['dist_pp']}")
        del pp_g, d_g
    check(plain.n == 0, f"plain twins called on the card's dist paths: "
                        f"{plain.by_twin}")
    torch.cuda.empty_cache()

    # ---- the new K2 shapes against the twin (outside the counted runs)
    with k2_train_io() as io:
        step.value_and_grad(params, pool_lr[sel[0]], pool_hr[sel[0]])
    pp_calls = [c for c in io.calls if c[0].shape[0] == t.batch // d.pp_micro]
    pp_held = hold_train_calls("pp", pp_calls)
    del io, pp_calls, params
    with k2_against_twin() as k2c:
        super_resolve_full_image(gen, sp_img, mesh=mesh)
    dist.destroy_process_group()
    check(len(k2c.rows) == n_esr and all(r[4] for r in k2c.rows),
          f"a halo-slab K2 launch beyond k2_forward_bound: "
          f"{[r for r in k2c.rows if not r[4]]}")
    halo_shapes = {(r[0], r[1]) for r in k2c.rows}
    print(f"[dist] {card}: every K2 launch of the split full image ({n_esr}, "
          f"{len(halo_shapes)} halo-slab shapes) within k2_forward_bound "
          f"(worst share {max(r[2] / r[3] for r in k2c.rows if r[3]):.3g}); "
          f"the PP microbatch convs at {len(pp_held['shapes'])} shapes: "
          f"forward max|err| {pp_held['fwd_err']:.3g}, dX share "
          f"{pp_held['dx_share']:.3g}, dW {pp_held['dw']:.2g}, db "
          f"{pp_held['db']:.2g}")
    del gen
    torch.cuda.empty_cache()

    gloo = gloo_ranks_on_card(d, cfg, trained, dev, seed, card)
    for name, c in gloo["counts"].items():
        launches[f"dist_gloo_{name}"] = c
    shapes = ({s for s in halo_shapes}
              | {s for s in gloo["tp_shapes"] if s[0][-1] != 3}
              | {(s[0], s[1]) for s in pp_held["shapes"]})
    times = k2_shape_times(shapes, dev)
    for (shape, relu), v in sorted(times.items()):
        print(f"[dist-K2] {card}: {shape} relu={relu}: K2 {v['ms']:.4f} ms, "
              f"twin {v['plain_ms']:.4f}, F.conv2d {v['library_ms']:.4f}, "
              f"bound {v['bound_ms']:.4f} ({v['bound_by']}), max|err| vs twin "
              f"{v['err']:.3g}")
    out.update(launches=launches, k2_times={str(k): v for k, v in times.items()},
               wall_s=time.perf_counter() - t0)
    print(f"[dist] phase wall {out['wall_s']:.1f} s")
    return out


def dist_card_rank(rank: int, world: int, init_file: str, out_dir: str,
                   spec: dict) -> None:
    """One rank of ``phase_dist_cards``, on card ``rank`` over NCCL: DP EDSR
    x4 at a global batch of 16 and of 16 a rank, the PP step over ``world``
    stages, full-image SR of g8x4 x4 and g32x23 x2 with the rows split; each
    against the unsharded run, with step times, per-rank peaks and the
    gradient all-reduce alone."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from tpusr_torch.dist import (full_image_esrgan_sr, make_mesh,
                                  make_pp_mesh, make_pp_train_step)
    from tpusr_torch.dist.mesh import (all_gather_cat, all_reduce_flat,
                                       axis_ranks)
    from tpusr_torch.dist.spatial import halo_convs, ring_attention
    from tpusr_torch.models import EDSR, ESRGANGenerator
    from tpusr_torch.train import SupervisedSRTrainer

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=world, device_id=dev,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = make_mesh(device=dev)
        t, seed = TrainSlice(), spec["seed"]
        g = torch.Generator(device=dev).manual_seed(seed + 20)
        pool_lr, pool_hr = sr_pairs(g, 16 * world, t, dev)

        def edsr():
            return EDSR(scale_factor=t.scale, num_res_blocks=t.blocks,
                        num_filters=t.filters, device=dev,
                        key=seed)

        # ---- DP: strong (global 16) and weak (16 a rank) scaling
        for name, n in (("dp16", 16), ("dp_weak", 16 * world)):
            lr, hr = pool_lr[:n], pool_hr[:n]
            dp = SupervisedSRTrainer(edsr(), learning_rate=1e-4, mesh=mesh,
                                     device=dev)
            single = SupervisedSRTrainer(edsr(), learning_rate=1e-4,
                                         device=dev)
            loss, _, gd = dp.value_and_grad(dp.init_state(), lr, hr)
            loss1, _, g1 = single.value_and_grad(single.init_state(), lr, hr)
            share = max(float((gd[k] - g1[k]).abs().max()
                              / g1[k].abs().max().clamp_min(1e-30)) for k in g1)
            flat = list(gd.values())
            # fixed counts: every rank must run the same collectives
            _, ar = timed_steps(lambda i: all_reduce_flat(
                flat, mesh.get_group("data")), 20)
            ar_ms = float(np.median(ar))
            state = dp.init_state()

            def step(i, state=state, dp=dp, lr=lr, hr=hr):
                return dp.train_step(state, lr, hr)[1]["loss"]
            dist.barrier()
            _, ms = timed_steps(step, 20)
            st1 = single.init_state()
            _, ms1 = timed_steps(lambda i: single.train_step(st1, lr, hr)[1]
                                 ["loss"], 10)
            out[name] = {"loss": float(loss), "loss_single": float(loss1),
                         "grad_share": share, "step_ms": float(np.median(ms)),
                         "single_ms": float(np.median(ms1)),
                         "allreduce_ms": ar_ms,
                         "grad_mb": sum(v.numel() for v in flat) * 4 / 1e6}
            del dp, single, gd, g1, flat, state

        # ---- PP over `world` stages, 4 microbatches of 4
        model = edsr().trainable()
        step = make_pp_train_step(model, make_pp_mesh(world, device=dev),
                                  n_micro=4)
        params = {k: v.detach() for k, v in model.named_parameters()}
        lr, hr = pool_lr[:16], pool_hr[:16]
        torch.cuda.reset_peak_memory_stats(dev)
        loss, gp = step.value_and_grad(params, lr, hr)
        pp_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        dense = SupervisedSRTrainer(edsr(), learning_rate=1e-4, device=dev)
        loss1, _, g1 = dense.value_and_grad(dense.init_state(), lr, hr)
        share = max(float((gp[k] - g1[k]).abs().max()
                          / g1[k].abs().max().clamp_min(1e-30)) for k in g1)
        dist.barrier()
        _, pp_times = timed_steps(lambda i: step(params, lr, hr), 10)
        pp_ms = float(np.median(pp_times))
        out["pp"] = {"loss": float(loss), "loss_single": float(loss1),
                     "grad_share": share, "step_ms": pp_ms, "peak_gb": pp_peak}
        del gp, g1, dense, model, params
        torch.cuda.empty_cache()

        # ---- SP: g8x4 x4 at 128^2, then g32x23 x2 at 128^2
        img = smooth_images(torch.Generator(device=dev).manual_seed(seed + 7),
                            1, 128, 3, dev) / 255.0 * 2 - 1
        ranks, me = axis_ranks(mesh, "data"), rank
        rows = 128 // world
        for name, (scale, growth, rrdb) in (("sp_g8", (4, 8, 4)),
                                            ("sp_g32", (2, 32, 23))):
            gen = ESRGANGenerator(scale, growth, rrdb, device=dev,
                                  key=seed)
            full_image_esrgan_sr(gen, img, mesh)   # NCCL's p2p set-up
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            dist.barrier()
            t0 = time.perf_counter()
            sr = full_image_esrgan_sr(gen, img, mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            launches = read_counts()["conv3x3_bias_act"]
            rec = {"ms": ms, "peak_gb": peak, "launches": launches}
            gen.attention_block_size = 4096
            if name == "sp_g8":
                with torch.no_grad():
                    dense_sr = gen(img)
                rec["err"] = float((sr - dense_sr).abs().max())
            else:
                # held as check_chaotic_generator holds the dense one: the
                # trunk (first order) against the twin's, the tail from the
                # twin's trunk against float64 (mean distance at most
                # TAIL_F64_RATIO x the twin's)
                with torch.no_grad():
                    x = img[:, me * rows:(me + 1) * rows].contiguous()
                    with halo_convs(gen, ranks, me):
                        t_sp = gen.trunk(x)
                    t_sp = all_gather_cat(t_sp, None, world, 1)
                    with models_on_k2_twin():
                        t_tw = gen.trunk(img)

                    def ring(gg, ff, hf):
                        return ring_attention(gg, ff, hf, ranks, me)
                    gen.attention_block_size, gen.attention_fn = None, ring
                    with halo_convs(gen, ranks, me):
                        tail_sp = gen.tail(t_tw[:, me * rows:(me + 1) * rows]
                                           .contiguous())
                    gen.attention_fn = None
                    tail_sp = all_gather_cat(tail_sp, None, world, 1)
                rec["trunk_err"] = float((t_sp - t_tw).abs().max())
                rec["trunk_tol"] = (2 + 15 * rrdb) * K2_ATOL
                if rank == 0:
                    gen.attention_block_size = 4096
                    with torch.no_grad(), models_on_k2_twin():
                        tail_tw = gen.tail(t_tw)
                        gen.double()
                        tail_64 = gen.tail(t_tw.double())
                        gen.float()
                    rec["tail_mean_sp"] = float((tail_sp.double() - tail_64)
                                                .abs().mean())
                    rec["tail_mean_twin"] = float((tail_tw.double() - tail_64)
                                                  .abs().mean())
                    rec["out_vs_twin_trunk_tail"] = float(
                        (sr - tail_tw).abs().max())
            out[name] = rec
            del gen, sr
            torch.cuda.empty_cache()
        dist.barrier()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_dist_cards(n: int, seed: int, card: str) -> None:
    """``n`` ranks, one card each, over NCCL (``dist_card_rank``), then
    ``entry.dryrun_multichip(n)`` on the same cards (the six checks with
    PP and SP over NCCL's send/recv, and the 2-process bootstrap)."""
    import shutil
    import tempfile

    from tpusr_torch.dist.bootstrap import spawn
    from tpusr_torch.entry import dryrun_multichip

    check(torch.cuda.device_count() >= n,
          f"--dist-cards {n}: {torch.cuda.device_count()} cards")
    work = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        t0 = time.perf_counter()
        spawn(dist_card_rank, n, (n, os.path.join(work, "init"), work,
                                  {"seed": seed}), timeout_s=420)
        res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
               for r in range(n)]
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t = TrainSlice()
    for r, o in enumerate(res):
        tag = f"[dist-cards rank {r}/{n}] {card}"
        for name in ("dp16", "dp_weak", "pp"):
            v = o[name]
            check(abs(v["loss"] - v["loss_single"]) <= 1e-5 * v["loss_single"]
                  and v["grad_share"] <= GRAD_RTOL, f"{tag} {name}: {v}")
        for name in ("dp16", "dp_weak"):
            v = o[name]
            print(f"{tag}: DP EDSR x{t.scale} at a global batch of "
                  f"{16 if name == 'dp16' else 16 * n} ({(16 if name == 'dp16' else 16 * n) // n} a rank): "
                  f"step median {v['step_ms']:.3f} ms (CUDA events, 20 steps) "
                  f"against {v['single_ms']:.3f} ms for the whole batch on one "
                  f"card; the gradient all-reduce alone ({v['grad_mb']:.2f} MB) "
                  f"{v['allreduce_ms']:.4f} ms; loss {v['loss']:.6f} == "
                  f"{v['loss_single']:.6f}, gradients within "
                  f"{v['grad_share']:.2g} of their max")
        v = o["pp"]
        print(f"{tag}: PP over {n} stages ({t.blocks // n} blocks each), 4 "
              f"microbatches of 4: step {v['step_ms']:.2f} ms, peak "
              f"{v['peak_gb']:.2f} GB; loss {v['loss']:.6f} == dense "
              f"{v['loss_single']:.6f}, gradients within {v['grad_share']:.2g}")
        g8 = o["sp_g8"]
        tol = 0.5 * g8["launches"] * K2_ATOL
        check(g8["err"] <= tol, f"{tag} SP g8: {g8['err']} > {tol}")
        g32 = o["sp_g32"]
        check(g32["trunk_err"] <= g32["trunk_tol"],
              f"{tag} SP g32 trunk {g32['trunk_err']} > {g32['trunk_tol']}")
        if r == 0:
            check(g32["tail_mean_sp"] <= TAIL_F64_RATIO * g32["tail_mean_twin"],
                  f"{tag} SP g32 tail: {g32}")
        print(f"{tag}: full image SR, {128 // n} of 128 rows a rank: g8x4 x4 "
              f"{g8['ms']:.1f} ms, peak {g8['peak_gb']:.2f} GB, "
              f"{g8['launches']} K2 on halo slabs, max|SR - dense| "
              f"{g8['err']:.3g} (tolerance {tol:.3g}); g32x23 x2 "
              f"{g32['ms']:.1f} ms, peak {g32['peak_gb']:.2f} GB a rank, trunk "
              f"against the twin's {g32['trunk_err']:.3g} (tolerance "
              f"{g32['trunk_tol']:.3g})"
              + (f", tail from the twin's trunk: mean distance from float64 "
                 f"{g32['tail_mean_sp']:.4g} against the dense twin's "
                 f"{g32['tail_mean_twin']:.4g} (held at most "
                 f"{TAIL_F64_RATIO:g}x)" if r == 0 else ""))
    print(f"[dist-cards] {n} NCCL ranks, one card each: wall {wall:.1f} s")
    t0 = time.perf_counter()
    dryrun_multichip(n, device="cuda")
    print(f"[dist-cards] dryrun_multichip({n}) on {n} cards: "
          f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- the EDA

@dataclass(frozen=True)
class EdaSlice:
    """The ``eda`` command on the reference's dataset shape: ``images`` HR
    ``size``^2 / LR ``size``/4 PNG pairs made on the card as
    ``phase_commands`` makes its surfaces, plus the committed JPEG pair
    (``tests/data/jpeg/eda_{hr,lr}.jpg``, 128^2 / 32^2); LPIPS-alex on
    seeded random weights; ``cpu_pairs`` PNG pairs and the JPEG pair run
    again on the CPU to hold the card's rows."""
    images: int = 16
    size: int = 512
    cpu_pairs: int = 2
    seed: int = 900              # the surfaces' draws: --seed plus this


JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
EDA_RTOL, EDA_LPIPS_ATOL = 1e-4, 1e-4


def random_lpips_npz(path: str, seed: int) -> str:
    """An LPIPS-alex bundle of N(0, 0.1) weights and |N(0, 0.1)| heads in
    the official layout (``tools/lpips_weights.expected_shapes``)."""
    from tpusr_torch.tools.lpips_weights import expected_shapes
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in expected_shapes().items():
        a = rng.standard_normal(shape).astype(np.float32) * 0.1
        flat[key] = np.abs(a) if key.startswith("lin") else a
    np.savez(path, **flat)
    return path


def check_jpeg_fixtures(sync) -> dict:
    """The JPEG decoder against cv2's decode of every committed fixture (its
    sha256, and its PNG where one is kept), the progressive one included;
    the decode's host ms at 128^2 and 512^2 (best of 3)."""
    import hashlib

    from tpusr_torch.pipeline.jpeg import decode_jpeg_u8
    from tpusr_torch.pipeline.png import decode_png_u8
    with open(os.path.join(JPEG_FIXTURES, "decoded.json")) as f:
        decoded = json.load(f)
    for name, want in decoded.items():
        with open(os.path.join(JPEG_FIXTURES, f"{name}.jpg"), "rb") as f:
            got = decode_jpeg_u8(f.read())
        check(list(got.shape) == want["shape"] and hashlib.sha256(
            got.tobytes()).hexdigest() == want["sha256"],
            f"JPEG fixture {name}: the decode differs from cv2's")
        twin = os.path.join(JPEG_FIXTURES, f"{name}.png")
        if os.path.exists(twin):
            with open(twin, "rb") as f:
                check(np.array_equal(decode_png_u8(f.read()), got),
                      f"JPEG fixture {name}: differs from its cv2 PNG")
    check("progressive" in decoded, "the progressive fixture has no entry")
    ms = {}
    for name in ("eda_hr", "q90_512"):
        with open(os.path.join(JPEG_FIXTURES, f"{name}.jpg"), "rb") as f:
            body = f.read()
        ms[name] = min(host_ms(lambda: decode_jpeg_u8(body), sync)
                       for _ in range(3))
    return {"n": len(decoded), "ms_128": ms["eda_hr"], "ms_512": ms["q90_512"]}


def phase_eda(e: EdaSlice, dev, seed: int, sync, card: str) -> dict:
    """``python -m tpusr_torch.cli eda`` in process on the card: the
    CSVs and the scenario pick, the launches (none: the EDA runs cuDNN and
    torch ops), the card's rows against the CPU's on a few pairs, and ms per
    pair split into decode, LPIPS and the rest."""
    import csv
    import pickle
    import shutil
    import tempfile

    from tpusr_torch.cli.__main__ import main as cli_main
    from tpusr_torch.data import eda as teda
    from tpusr_torch.metrics.lpips import load_lpips_npz

    t_phase = time.perf_counter()
    jpeg = check_jpeg_fixtures(sync)
    work = tempfile.mkdtemp(prefix="chip_smoke_eda_")
    try:
        data = os.path.join(work, "data")
        write_reference_dataset(data, CommandsSlice(images=e.images,
                                                    size=e.size),
                                seed + e.seed, dev, maps=True)
        for sub, name in (("HR", "eda_hr"), ("LR", "eda_lr")):
            shutil.copy(os.path.join(JPEG_FIXTURES, f"{name}.jpg"),
                        os.path.join(data, sub, "jpeg_pair.jpg"))
        npz = random_lpips_npz(os.path.join(work, "lpips_alex.npz"), seed)
        imap_path = os.path.join(data, "interp_map.pkl")
        out = os.path.join(work, "eda")
        timings, result = {}, {}

        def keep(orig):
            def run(*a, **kw):
                result["rows"], result["gd"] = orig(*a, **kw)
                return result["rows"], result["gd"]
            return run

        def timed(orig):
            return lambda *a, **kw: orig(*a, **{**kw, "timings": timings})

        reset_counts()
        with count_plain_calls() as plain, patched(
                teda, run_eda_pipeline=keep, collect_metrics=timed), \
                figure_stage(sync) as figs:
            sync()
            t0 = time.perf_counter()
            cli_main(["eda", "--hr-dir", os.path.join(data, "HR"),
                      "--lr-dir", os.path.join(data, "LR"), "--out", out,
                      "--interp-map", imap_path, "--lpips-weights", npz,
                      "--device", "cuda"])
            sync()
            wall = time.perf_counter() - t0
        counts = read_counts()
        check(counts == launches_want(), f"kernels launched by the EDA: "
                                         f"{counts}")
        check(plain.n == 0, f"plain twins on the card in the EDA: "
                            f"{plain.by_twin}")
        rows, gd = result["rows"], result["gd"]
        n = e.images + 1
        check(len(rows) == n == gd["count"], f"EDA rows {len(rows)} != {n}")
        with open(os.path.join(out, "eda_metrics.csv"), newline="") as f:
            table = list(csv.reader(f))
        check(table[0] == list(rows[0]) and len(table) == n + 1,
              "eda_metrics.csv: header or rows")
        bad = [(r[0], k, v) for r in table[1:] for k, v in zip(table[0], r)
               if k != "filename" and not math.isfinite(float(v))]
        check(not bad, f"non-finite EDA values: {bad[:4]}")
        with open(os.path.join(out, "eda_summary.csv"), newline="") as f:
            summary = list(csv.reader(f))
        check(summary[0] == ["", *teda.SUMMARY_COLUMNS]
              and len(summary) == len(rows[0]), "eda_summary.csv: its shape")
        for key in ("lr_fft_sum", "hr_fft_sum", "grad_hr_sum", "glcm_sum"):
            check(np.isfinite(gd[key]).all(), f"gd[{key}] not finite")
        sc = gd["scenarios"]
        check(sc["key"] == "lpips" and len(sc["best"]) == len(sc["worst"]) == 1,
              f"scenario pick {sc}")
        want = list(EDA_FIGURES) + [
            os.path.join("LPIPS_Scenarios", d, pre + os.path.basename(f))
            for d, names in (("best_scenarios", sc["best"]),
                             ("worst_scenarios", sc["worst"]))
            for f in names for pre in ("", "advanced_")]
        figures = check_figures("eda", figs, out, want, card)
        print(f"[figures] eda: its figure stage {figures['ms']:.1f} ms of the "
              f"command's {wall * 1e3:.0f} ms")

        # the card's rows against a CPU run of the same pairs
        cpu = os.path.join(work, "cpu")
        names = ["jpeg_pair.jpg"] + sorted(
            f for f in os.listdir(os.path.join(data, "HR"))
            if f.endswith(".png"))[:e.cpu_pairs]
        for sub in ("HR", "LR"):
            os.makedirs(os.path.join(cpu, sub))
            for name in names:
                shutil.copy(os.path.join(data, sub, name),
                            os.path.join(cpu, sub, name))
        with open(imap_path, "rb") as f:
            imap = pickle.load(f)
        cpu_rows, _ = teda.collect_metrics(
            os.path.join(cpu, "LR"), os.path.join(cpu, "HR"), interp_map=imap,
            lpips_net=load_lpips_npz(npz, device="cpu"), device="cpu")
        by_name = {r["filename"]: r for r in rows}
        worst_rel, worst_lpips = 0.0, 0.0
        for want in cpu_rows:
            got = by_name[want["filename"]]
            for k, w in want.items():
                if k == "filename":
                    continue
                d = abs(got[k] - w)
                if k == "lpips":
                    worst_lpips = max(worst_lpips, d)
                    check(d <= EDA_LPIPS_ATOL, f"LPIPS of {want['filename']} on "
                          f"the card {got[k]} against the CPU's {w}")
                else:
                    worst_rel = max(worst_rel, d / max(abs(w), 1e-9))
                    check(math.isclose(got[k], w, rel_tol=EDA_RTOL,
                                       abs_tol=1e-9),
                          f"EDA {k} of {want['filename']}: card {got[k]}, "
                          f"CPU {w}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    med = {k: float(np.median(v)) for k, v in timings.items()}
    print(f"[eda] {card}: `python -m tpusr_torch.cli eda` on {e.images} PNG "
          f"pairs of {e.size}^2/{e.size // 4}^2 and 1 JPEG pair of 128^2/32^2 "
          f"({n} rows, LPIPS-alex on seeded random weights): {wall:.2f} s, "
          f"median per pair: decode {med['decode']:.2f} ms, LPIPS "
          f"{med['lpips']:.2f} ms, the rest {med['rest']:.2f} ms; no kernel "
          f"launched, no plain twin; eda_metrics.csv and eda_summary.csv "
          f"finite; best/worst by LPIPS {sc['best']} / {sc['worst']}")
    print(f"[eda] the card's rows against the CPU's on {len(cpu_rows)} pairs "
          f"(JPEG pair included): largest relative difference "
          f"{worst_rel:.3g} (held at {EDA_RTOL:g}), LPIPS {worst_lpips:.3g} "
          f"(held at {EDA_LPIPS_ATOL:g}); the JPEG decoder equal to cv2 on "
          f"{jpeg['n']} fixtures, the progressive one included; decode "
          f"{jpeg['ms_128']:.1f} ms at 128^2, {jpeg['ms_512']:.1f} ms at "
          f"512^2 (host); the phase {time.perf_counter() - t_phase:.2f} s "
          f"(the surfaces made on the card and the CPU run included)")
    return {"launches": counts, "wall_s": wall, "per_pair_ms": med,
            "jpeg": jpeg, "figures": figures}


# ------------------------------------------------- the polyphase SR path

@dataclass(frozen=True)
class PolySlice:
    """The uncomposed polyphase SR path (``edsr_fast.make_poly_sr_apply``):
    EDSR x4 at full width on a batch of LR images, f32 and bf16."""
    lr: int = 128
    batch: int = 16
    blocks: int = 16
    filters: int = 64


def poly_launches(p: PolySlice) -> int:
    """K2 launches of one polyphase x4 forward: the head, two per residual
    block, the body, up0 and up1 (the refactored tail is ``F.conv2d``)."""
    return 1 + 2 * p.blocks + 1 + 2


def phase_poly(p: PolySlice, dev, seed: int, sync, card: str) -> dict:
    """``make_poly_sr_apply`` in f32 and bf16 against ``edsr.forward`` (f32
    at ``SR_ATOL``, bf16 by PSNR), each launch counted and held against its
    twin (f32 by ``k2_forward_bound``, bf16 by ``k2_bf16_tolerance``), timed
    beside the fused path; K2's ms at the path's shapes beside
    ``F.conv2d``."""
    from tpusr_torch.models.edsr import EDSR
    from tpusr_torch.models.edsr_fast import (make_fused_sr_apply,
                                              make_poly_sr_apply)
    from tpusr_torch.models.layers import pixel_shuffle

    edsr = EDSR(scale_factor=4, num_res_blocks=p.blocks,
                num_filters=p.filters, device=dev,
                key=seed + 14)
    g = torch.Generator(device=dev).manual_seed(seed + 15)
    x = smooth_images(g, p.batch, p.lr, 3, dev) / 255.0
    want = poly_launches(p)
    res, launches, shapes = {}, {}, {}
    with torch.inference_mode():
        ref = edsr(x)
        for dtype, name in ((torch.float32, "conv3x3_bias_act"),
                            (torch.bfloat16, "conv3x3_bias_act_bf16")):
            tag = "f32" if dtype == torch.float32 else "bf16"
            fn, r = make_poly_sr_apply(edsr, dtype)
            fused, s = make_fused_sr_apply(edsr, dtype)
            fn(x)
            sync()
            with count_plain_calls() as plain:
                reset_counts()
                y = fn(x)
                sync()
                counts = read_counts()
            check(counts == launches_want(**{name: want}),
                  f"poly {tag} launches {counts}, want {want} of {name}")
            check(plain.n == 0, f"plain twins on the card: {plain.by_twin}")
            launches[name] = counts[name]
            sr = pixel_shuffle(y, r).float()
            check(tuple(sr.shape) == (p.batch, 4 * p.lr, 4 * p.lr, 3)
                  and bool(torch.isfinite(sr).all()), f"poly {tag} SR shape")
            with k2_against_twin() as k2c:
                fn(x)
            check(len(k2c.rows) == want and all(r_[4] for r_ in k2c.rows),
                  f"poly {tag}: a K2 launch beyond its bound against the twin "
                  f"({sum(not r_[4] for r_ in k2c.rows)} of {len(k2c.rows)})")
            fused_sr = pixel_shuffle(fused(x), s).float()
            if dtype == torch.float32:
                err = float((sr - ref).abs().max())
                check(err <= SR_ATOL, f"poly f32 SR vs edsr.forward {err}")
                for shape, relu, *_ in k2c.rows:
                    shapes[(shape, relu)] = shapes.get((shape, relu), 0) + 1
                quality = f"max|SR - edsr.forward| {err:.3g}"
            else:
                db, fused_db = psnr_db(sr, ref), psnr_db(fused_sr, ref)
                check(db >= BF16_SR_MIN_PSNR, f"poly bf16 SR PSNR {db:.2f} dB")
                quality = (f"PSNR against the f32 forward {db:.2f} dB (fused "
                           f"bf16 {fused_db:.2f})")
            res[tag] = {"ms": time_ms(lambda: fn(x)),
                        "fused_ms": time_ms(lambda: fused(x))}
            print(f"[poly] {card}: {tag} make_poly_sr_apply, EDSR x4 "
                  f"{p.blocks}x{p.filters} on {p.batch} LR {p.lr}^2: "
                  f"{counts[name]} {name} launches, each within its bound of "
                  f"the twin (largest err {max(r_[2] for r_ in k2c.rows):.3g}, "
                  f"bound {max(r_[3] for r_ in k2c.rows):.3g}); {quality}; "
                  f"{res[tag]['ms']:.3f} ms a forward against the fused "
                  f"path's {res[tag]['fused_ms']:.3f} ms (CUDA events)")
            del y, sr, fused_sr
    times = k2_shape_times({k: None for k in shapes}, dev)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "err": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
    for key_, t in times.items():
        n = shapes[key_]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += n * t[key]
        tot["t_" + ("ops" if t["bound_by"] == "operations" else "bytes")] += \
            n * t["bound_ms"]
        tot["err"] = max(tot["err"], t["err"])
        print(f"[poly-K2] {str(key_[0]):26s} relu={int(key_[1])} x{n}: kernel "
              f"{t['ms']:.4f} ms  F.conv2d fp32 {t['library_ms']:.4f} ms  twin "
              f"{t['plain_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms")
    print(f"[poly-K2] {card}: {want} launches a forward, kernel "
          f"{tot['ms']:.3f} ms, F.conv2d fp32 {tot['library_ms']:.3f} ms, "
          f"bound {tot['bound_ms']:.3f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f}%)")
    del edsr, x, ref
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": res, "k2": tot}


# ---------------------------------------------------------------- Winograd

@dataclass(frozen=True)
class WinogradSlice:
    """Winograd F(2x2, 3x3) (``core/winograd.py``) at VGG16's block-2 to
    block-4 convs on ``patches`` patches of ``patch``^2, every output held
    against float64 at the batch that is timed."""
    patches: int = 64
    patch: int = 96
    s_x: float = 0.05


def _winograd64(x: torch.Tensor, wt: torch.Tensor, bt: torch.Tensor,
                at: torch.Tensor) -> torch.Tensor:
    """A^T [ (B^T d B) .* W ] A summed over input channels, in float64:
    x (B, H, W, K), wt (4, 4, K, N), the 4x4 ``bt`` and 2x4 ``at`` given, so
    that their magnitudes can stand in for them."""
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    d = xp.unfold(1, 4, 2).unfold(2, 4, 2)            # (B, th, tw, K, 4, 4)
    u = torch.einsum("ai,btwkij,cj->btwkac", bt, d, bt)
    y = torch.einsum("btwkac,ackn->btwacn", u, wt.double())
    y = torch.einsum("ea,btwacn,fc->btwefn", at, y, at)
    b, th, tw, _, _, n = y.shape
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * th, 2 * tw, n)


def winograd_bounds(x: torch.Tensor, k: torch.Tensor, xq: torch.Tensor,
                    s_x: float, wq: torch.Tensor, rescale: torch.Tensor):
    """Per-output bounds (float64) on the distance of the port's Winograd
    results from the exact conv:

    - f32 (x, k): ``2 (K + 16) 2^-24 S``, S = |A|^T [(|B|^T |d| |B|) .*
      (|G| |g| |G|^T)] |A|: the fp32 sums of the input transform (3 adds),
      the weight transform (~4), the products, the K-term GEMM and the
      9-term output transform, doubled as K2's bound is;
    - int8 (xq scaled by s_x, k): ``s_x |A|^T [ |uq - u| |Wq| + |u| |Wq - W|
      ] |A|`` summed over channels, u = B^T d B exact, uq its requantised
      grid value (x4), W = G g G^T, Wq = wq * rescale / (4 s_x), plus 16
      2^-24 of the same sum on |uq||Wq| for the float rescale and output
      transform."""
    from tpusr_torch.core import winograd as wg
    dev = x.device
    bt, g, at = (torch.from_numpy(m).double().to(dev)
                 for m in (wg._BT, wg._G, wg._AT))
    kk = k.double()
    w_abs = torch.einsum("ai,ijkn,bj->abkn", g.abs(), kk.abs(), g.abs())
    s_f32 = _winograd64(x.abs(), w_abs, bt.abs(), at.abs())
    f32 = 2 * (x.shape[-1] + 16) * 2.0 ** -24 * s_f32
    # int8: the exact transform u, its requantised value, the two weights
    xp = F.pad(xq.double(), (0, 0, 1, 1, 1, 1))
    d = xp.unfold(1, 4, 2).unfold(2, 4, 2)
    u = torch.einsum("ai,btwkij,cj->btwkac", bt, d, bt)
    uq = 4 * wg._requant_u4(u.round().to(torch.int32)).double()
    w_exact = torch.einsum("ai,ijkn,bj->abkn", g, kk, g)
    wq_real = (wq.double() * rescale.double() / (4 * s_x)).reshape(
        4, 4, *wq.shape[1:])

    def assemble(a, w):
        y = torch.einsum("btwkac,ackn->btwacn", a, w)
        y = torch.einsum("ea,btwacn,fc->btwefn", at.abs(), y, at.abs())
        b, th, tw, _, _, n = y.shape
        return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * th, 2 * tw, n)

    int8 = s_x * (assemble((uq - u).abs(), wq_real.abs())
                  + assemble(u.abs(), (wq_real - w_exact).abs())
                  + 16 * 2.0 ** -24 * assemble(uq.abs(), wq_real.abs()))
    return f32, int8


def phase_winograd(w: WinogradSlice, dev, seed: int, card: str) -> dict:
    """f32 Winograd against a float64 conv and int8 Winograd against the
    exact conv of its int8 input, each within ``winograd_bounds``, and the
    int8 result's distance from the direct int8 dequant conv; each timed
    (CUDA events) beside ``F.conv2d`` fp32 (TF32 off) and the direct int8
    conv at every distinct conv shape of VGG16 blocks 2-4."""
    from tpusr_torch.core import winograd as wg
    from tpusr_torch.core.conv3x3 import (conv3x3_int8_dequant,
                                          pack_int8_kernel)
    shapes = vgg_conv_shapes(w.patches, w.patch // 2, (64, 128, 256, 512, 512),
                             first_block=2)[:8]
    uses = {}
    for s in shapes:
        uses[s] = uses.get(s, 0) + 1
    g = torch.Generator(device=dev).manual_seed(seed + 16)
    tot = {"f32": 0.0, "conv2d": 0.0, "int8": 0.0, "direct_int8": 0.0}
    for shape, n_use in uses.items():
        n, h, wd, cin, cout = shape
        x = torch.randn((n, h, wd, cin), generator=g, device=dev)
        k = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
             * math.sqrt(2.0 / (9 * cin)))
        k_oihw = k.permute(3, 2, 0, 1).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)
        xq = torch.randint(-127, 128, (n, h, wd, cin), generator=g,
                           device=dev, dtype=torch.int8)
        wq, rescale = wg.quantize_winograd_weights(k, wg.int8_u_scales(w.s_x))
        check(wq.device == rescale.device == x.device,
              "quantize_winograd_weights left the kernel's device")
        bnd32, bnd8 = winograd_bounds(x, k, xq, w.s_x, wq, rescale)
        # f32 against the float64 conv, within its derived bound, on the
        # whole batch that is timed below
        y64 = F.conv2d(x_nchw.double(), k_oihw.double(),
                       padding=1).permute(0, 2, 3, 1)
        d32 = (wg.winograd_conv(x, k).double() - y64).abs()
        err_c = float((F.conv2d(x_nchw, k_oihw, padding=1).permute(
            0, 2, 3, 1).double() - y64).abs().max())
        check(bool((d32 <= bnd32).all()),
              f"Winograd f32 at {shape}: {int((d32 > bnd32).sum())} outputs "
              f"beyond the derived bound")
        # int8 against the exact conv of the int8 input, within its bound
        y8_64 = F.conv2d(xq.permute(0, 3, 1, 2).double() * w.s_x,
                         k_oihw.double(), padding=1).permute(0, 2, 3, 1)
        y_w8 = wg.winograd_conv_int8(xq, w.s_x, wq, rescale)
        d8 = (y_w8.double() - y8_64).abs()
        check(bool((d8 <= bnd8).all()),
              f"Winograd int8 at {shape}: {int((d8 > bnd8).sum())} outputs "
              f"beyond the derived bound")
        # the direct int8 conv (per-channel weights, bf16 out) beside it
        ws = (k.abs().amax(dim=(0, 1, 2)) / 127.0).clamp_min(1e-12)
        kq = (k / ws).round().clamp(-127, 127).to(torch.int8)
        kp = pack_int8_kernel(kq)
        rs, zero = (w.s_x * ws).float(), torch.zeros(cout, device=dev)
        y_d8 = conv3x3_int8_dequant(xq, kq, rs, zero, kp).float()
        err8 = float((y_w8 - y_d8).abs().max())
        scale8 = float(y_d8.abs().max())
        err_w, scale = float(d32.max()), float(y64.abs().max())
        t = {"f32": time_ms(lambda: wg.winograd_conv(x, k), min_total_ms=10.0),
             "conv2d": time_ms(lambda: F.conv2d(x_nchw, k_oihw, padding=1),
                               min_total_ms=10.0),
             "int8": time_ms(lambda: wg.winograd_conv_int8(xq, w.s_x, wq,
                                                           rescale),
                             min_total_ms=10.0),
             "direct_int8": time_ms(lambda: conv3x3_int8_dequant(
                 xq, kq, rs, zero, kp), min_total_ms=10.0)}
        for key in tot:
            tot[key] += n_use * t[key]
        print(f"[winograd] {str(shape):26s} x{n_use}: f32 {t['f32']:.4f} ms "
              f"(max|err| {err_w:.3g} from float64, largest bound "
              f"{float(bnd32.max()):.3g}, F.conv2d's err {err_c:.3g}, max|y| "
              f"{scale:.3g}) against F.conv2d fp32 {t['conv2d']:.4f} ms; "
              f"int8 {t['int8']:.4f} ms (max|err| {float(d8.max()):.3g}, "
              f"largest bound {float(bnd8.max()):.3g}; {err8:.3g} from the "
              f"direct int8 conv's bf16 output, max {scale8:.3g}) against the "
              f"direct int8 dequant conv {t['direct_int8']:.4f} ms")
        del x, xq, y64, y8_64, y_w8, y_d8, bnd32, bnd8, d32, d8
    torch.cuda.empty_cache()
    print(f"[winograd] {card}: VGG16 blocks 2-4 ({len(shapes)} convs) on "
          f"{w.patches} patches of {w.patch}^2: f32 Winograd {tot['f32']:.3f} "
          f"ms against F.conv2d fp32 {tot['conv2d']:.3f} ms "
          f"({tot['f32'] / tot['conv2d']:.2f}x); int8 Winograd "
          f"{tot['int8']:.3f} ms against the direct int8 conv "
          f"{tot['direct_int8']:.3f} ms ({tot['int8'] / tot['direct_int8']:.2f}x)")
    return tot


# ---------------------------------------------------------------------- h5

@dataclass(frozen=True)
class H5Slice:
    """``phase_h5``'s sizes: every network at the reference's full widths
    (EDSR x4 16x64, ESRGAN g32x23 x4, the discriminator at 96^2, SRCNN
    96/32, VGG16 with its 256-unit head) through the port's Keras ``.h5``
    export and import."""
    lr: int = 128                # EDSR x4 SR: 16 LR 128^2
    batch: int = 16
    growth: int = 32             # the reference's generator: g32 x 23 RRDB
    rrdb: int = 23
    gen_lr: int = 32             # g32x23 x4 SR: 2 LR 32^2 (dense attention)
    gen_batch: int = 2
    disc_hw: int = 96
    patch: int = 96              # SRCNN's and VGG16's inputs
    vgg_seed: int = 19           # the VGG19/VGG16 notop files' draws: --seed plus
    notop_seed: int = 16


KERAS_FIXTURES = os.path.join(REPO, "tests", "data", "keras")


def check_keras_fixtures() -> int:
    """Every committed Keras fixture read by the port's codec: each
    dataset's sha256 and each attribute's type and decoded value equal to
    the manifest h5py wrote beside them. Returns the records held."""
    from tpusr_torch.train import hdf5

    with open(os.path.join(KERAS_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    n = 0
    for name, want in manifest["files"].items():
        got = hdf5.describe(os.path.join(KERAS_FIXTURES, name))
        bad = [w["path"] for g, w in zip(got, want) if g != w]
        check(got == want, f"{name}: the codec's view differs from h5py's "
                           f"at {bad[:3] or 'its length'}")
        n += len(want)
    return n


def write_vgg_notop(path: str, backbone) -> None:
    """A VGG base's weights as the official Keras ``*_notop.h5`` releases
    lay them out (``save_weights``: layer groups at the root with the input
    and pool layers weightless, fixed-length name lists, weight names
    ``block1_conv1/kernel:0``), written by the port's codec."""
    from tpusr_torch.train import hdf5

    names, prev = ["input_1"], None
    for layer in backbone.keys():
        if prev and prev[:6] != layer[:6]:
            names.append(f"{prev[:6]}_pool")
        names.append(layer)
        prev = layer
    names.append(f"{prev[:6]}_pool")
    with hdf5.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in names])
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        f.attrs["keras_version"] = np.bytes_(b"2.2.4")
        for name in names:
            g = f.create_group(name)
            if name not in backbone:
                g.attrs["weight_names"] = []
                continue
            wn = [f"{name}/kernel:0", f"{name}/bias:0"]
            g.attrs["weight_names"] = np.array([w.encode() for w in wn])
            conv = backbone[name]
            g.create_dataset(wn[0], data=conv.weight.detach().permute(
                2, 3, 1, 0).cpu().numpy())
            g.create_dataset(wn[1], data=conv.bias.detach().cpu().numpy())


def backbone_arrays(backbone) -> dict:
    """{'<layer>/kernel' (HWIO), '<layer>/bias': array} of a VGG base."""
    out = {}
    for name, conv in backbone.items():
        out[f"{name}/kernel"] = conv.weight.detach().permute(
            2, 3, 1, 0).cpu().numpy()
        out[f"{name}/bias"] = conv.bias.detach().cpu().numpy()
    return out


def checkpoint_leaves(path: str) -> dict:
    """An Orbax checkpoint's leaves (``train/orbax.py``) by key path, its
    zstd decoded on the card."""
    from tpusr_torch.train import orbax
    return {tuple(k for k, _t in keys): v
            for keys, v in orbax._flatten(orbax.read(path, device="cuda"))}


def checkpoint_leaves_equal(a: str, b: str) -> tuple[bool, int]:
    """(every leaf of two checkpoints equal, dtypes too; the leaves
    compared)."""
    la, lb = checkpoint_leaves(a), checkpoint_leaves(b)
    same = la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k])
        for k in la)
    return same, len(la)


def phase_h5(s: H5Slice, cfg: Slice, dev, seed: int, sync, card: str) -> dict:
    """The Keras ``.h5`` codec of the port (``train/hdf5.py``,
    ``keras_export.py``, ``keras_import.py``) at full width: the committed
    fixtures read without h5py; each facade's seeded weights saved by
    ``save_h5`` and set up again from the file, then run on the card
    beside the source (EDSR x4, the g32x23 generator's trunk and SR and the
    discriminator at 96^2 with its ``u``, SRCNN, VGG16): equal bit for bit;
    the shipped mode served on the imported EDSR and VGG16 against the
    source's (K1, K2, K3 each held to its twin); ``cli convert`` of the four
    checkpoints to ``.h5`` and back, every tensor equal; ``train-esrgan
    --vgg19-weights`` on a VGG19 notop ``.h5`` against the same weights as
    ``.npz``; the ImageNet tool's ``.h5`` -> ``.npz``. Each main-path run is
    driven with the launch counts set to 0 just before it and read just
    after, summed under ``h5``. Returns those launches."""
    import shutil
    import tempfile

    from tpusr_torch.cli.__main__ import main as cli_main
    from tpusr_torch.config import ESRGANConfig
    from tpusr_torch.core.patches import patchify
    from tpusr_torch.models.api import (EDSR as EDSRFacade, ESRGAN,
                                        FineTunedVGG16, SRCNNModel)
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply
    from tpusr_torch.models.layers import pixel_shuffle
    from tpusr_torch.models.vgg import VGG16Classifier, VGG19Features
    from tpusr_torch.pipeline import make_serving_pipeline
    from tpusr_torch.train import hdf5, keras_import
    from tpusr_torch.train import gan as gan_mod
    from torch.func import functional_call

    t_phase = time.perf_counter()
    total = {k: 0 for k in read_counts()}

    def main_path(fn):
        reset_counts()
        out = fn()
        sync()
        for k, v in read_counts().items():
            total[k] += v
        return out

    def host(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def equal_params(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)

    files = []                  # (name, path, write ms)
    n_records = check_keras_fixtures()
    print(f"[h5] the {n_records} records of the committed Keras fixtures "
          f"(tests/data/keras, written by JAX's exporters with Keras 3) read "
          f"by the port's codec equal to h5py's manifest: every dataset's "
          f"sha256, every attribute's type and value")
    work = tempfile.mkdtemp(prefix="chip_smoke_h5_")
    rng = np.random.default_rng(seed + 15)
    try:
        # ---- EDSR x4, 16 blocks of 64 ----
        src = EDSRFacade(device=dev)
        src.setup_model(scale_factor=cfg.scale, num_res_blocks=cfg.blocks,
                        num_filters=cfg.filters)
        src.trained = True
        h5, w_ms = host(lambda: src.save_h5(work, "h5"))
        files.append((f"EDSR x{cfg.scale} {cfg.blocks}x{cfg.filters}", h5,
                      w_ms))
        dst = EDSRFacade(device=dev)
        dst.setup_model(scale_factor=cfg.scale, num_res_blocks=cfg.blocks,
                        num_filters=cfg.filters, from_pretrained=True,
                        pretrained_path=h5)
        check(equal_params(dst.state.params, src.state.params),
              "EDSR: the imported weights differ from the saved ones")
        x = torch.as_tensor(rng.random((s.batch, s.lr, s.lr, 3),
                                       dtype=np.float32), device=dev)
        edsr_src, edsr_dst = src.network(), dst.network()
        with torch.inference_mode():
            a = main_path(lambda: edsr_src(x))
            b = main_path(lambda: edsr_dst(x))
            with k2_against_twin() as k2c:
                edsr_dst(x[:2])
        check(torch.equal(a, b), "EDSR: the imported model's SR differs")
        check(len(k2c.rows) == 2 * cfg.blocks + 5 and all(r[4] for r in k2c.rows),
              f"EDSR: K2 beyond its bound against the twin at "
              f"{[r[0] for r in k2c.rows if not r[4]]}")
        print(f"[h5] EDSR x{cfg.scale} ({cfg.blocks} blocks, {cfg.filters} "
              f"filters): save_h5 -> setup_model(from_pretrained=.h5): "
              f"weights equal, the SR of {s.batch} x {s.lr}^2 on K2 "
              f"torch.equal to the source's {tuple(a.shape)}; its "
              f"{len(k2c.rows)} K2 launches within their per-output bound "
              f"of the twin (largest err {max(r[2] for r in k2c.rows):.3g})")

        # ---- ESRGAN g32x23 x4 and the discriminator at 96^2 ----
        kw = dict(scale_factor=4, growth_channels=s.growth,
                  num_rrdb_blocks=s.rrdb,
                  input_shape=(s.disc_hw // 4, s.disc_hw // 4, 3),
                  output_shape=(s.disc_hw, s.disc_hw, 3))
        esrc = ESRGAN(device=dev)
        esrc.setup_model(**kw)
        esrc.trained = True
        (g_h5, d_h5), w_ms = host(lambda: esrc.save_h5(work, "h5"))
        with hdf5.File(g_h5) as f:
            members = len(f["model_weights"])
            config_bytes = len(f.attrs["model_config"].encode("utf-8"))
        gan_tag = f"g{s.growth}x{s.rrdb} x4"
        files += [(f"ESRGAN generator {gan_tag} (write: both files)", g_h5,
                   w_ms), (f"ESRGAN discriminator {s.disc_hw}^2", d_h5, None)]
        edst = ESRGAN(device=dev)
        edst.setup_model(from_trained=True, generator_pretrained_path=g_h5,
                         discriminator_pretrained_path=d_h5, **kw)
        for tree in ("g_params", "d_params", "d_spectral"):
            check(equal_params(getattr(edst.state, tree),
                               getattr(esrc.state, tree)),
                  f"ESRGAN: the imported {tree} differ from the saved ones")
        lr = torch.as_tensor(rng.random((s.gen_batch, s.gen_lr, s.gen_lr, 3),
                                        dtype=np.float32) * 2 - 1, device=dev)
        g_src, g_dst = esrc.network(), edst.network()
        with torch.inference_mode():
            ta = main_path(lambda: g_src.trunk(lr))
            tb = main_path(lambda: g_dst.trunk(lr))
            sa = main_path(lambda: g_src.tail(ta))
            sb = main_path(lambda: g_dst.tail(tb))
            with k2_against_twin() as k2c:
                g_dst(lr[:1])
            hr = torch.as_tensor(rng.random((s.batch, s.disc_hw, s.disc_hw, 3),
                                            dtype=np.float32), device=dev)
            da = functional_call(esrc.discriminator,
                                 {**esrc.state.d_params,
                                  **esrc.state.d_spectral}, (hr,))
            db = functional_call(edst.discriminator,
                                 {**edst.state.d_params,
                                  **edst.state.d_spectral}, (hr,))
        n_gen = esrgan_launches(s.rrdb, 4)
        check(torch.equal(ta, tb) and torch.equal(sa, sb),
              "ESRGAN: the imported generator's trunk or SR differs")
        check(torch.equal(da, db), "ESRGAN: the imported discriminator's "
                                   "logits differ")
        check(len(k2c.rows) == n_gen and all(r[4] for r in k2c.rows),
              f"ESRGAN: K2 beyond its bound against the twin at "
              f"{[r[0] for r in k2c.rows if not r[4]]}")
        print(f"[h5] ESRGAN {gan_tag}: "
              f"the generator's file has {members} members in model_weights "
              f"(a group B-tree of depth {1 + (members > 256)}) and a "
              f"model_config of {config_bytes} bytes; from_trained on the two "
              f"files: g_params, d_params and the spectral u equal; the trunk "
              f"{tuple(ta.shape)} and the SR {tuple(sa.shape)} of "
              f"{s.gen_batch} x {s.gen_lr}^2 torch.equal to the source's; its "
              f"{len(k2c.rows)} K2 launches within their per-output bound of "
              f"the twin; the discriminator's {s.batch} logits at "
              f"{s.disc_hw}^2 torch.equal")

        # ---- SRCNN 96/32 and the VGG16 classifier ----
        outs = {}
        for tag, facade, setup in (
                ("SRCNN 96/32", SRCNNModel, {}),
                ("VGG16 classifier", FineTunedVGG16,
                 {"input_shape": (s.patch, s.patch, 3)})):
            fsrc = facade(device=dev)
            fsrc.setup_model(**setup)
            fsrc.trained = fsrc._trained = True
            path, w_ms = host(lambda: fsrc.save_h5(work, "h5"))
            files.append((tag, path, w_ms))
            fdst = facade(device=dev)
            fdst.setup_model(from_pretrained=True, pretrained_path=path,
                             **setup)
            check(equal_params(fdst.state.params, fsrc.state.params),
                  f"{tag}: the imported weights differ")
            xi = torch.as_tensor(rng.random((s.batch, s.patch, s.patch, 3),
                                            dtype=np.float32), device=dev)
            with torch.inference_mode():
                ya = fsrc.network()(xi)
                yb = fdst.network()(xi)
            check(torch.equal(ya, yb), f"{tag}: the imported model's output "
                                       f"differs")
            outs[tag] = (fsrc, fdst, tuple(ya.shape))
        print(f"[h5] SRCNN (96/32) and the VGG16 classifier: save_h5 -> "
              f"from_pretrained: weights equal, outputs "
              f"{outs['SRCNN 96/32'][2]} and probabilities "
              f"{outs['VGG16 classifier'][2]} torch.equal to the source's")

        # ---- the shipped mode on the imported EDSR and VGG16 ----
        vgg_src, vgg_dst, _ = outs["VGG16 classifier"]
        gain = rng.uniform(0.05, 1.0, (cfg.batch + 4, 1, 1, 1)).astype(np.float32)
        imgs = torch.as_tensor(rng.random((cfg.batch + 4, cfg.lr, cfg.lr, 3),
                                          dtype=np.float32) * gain, device=dev)
        batch, calib_lr = imgs[:cfg.batch], imgs[cfg.batch:]
        fn, r = make_fused_sr_apply(edsr_src)
        with torch.inference_mode():
            calib = patchify(pixel_shuffle(fn(calib_lr), r), cfg.patch,
                             cfg.stride)
            calib = calib.reshape((-1,) + calib.shape[2:])[:64]

        def build(edsr, vgg):
            return make_serving_pipeline(
                edsr, vgg, (cfg.lr, cfg.lr), cfg.scale, patch=cfg.patch,
                stride=cfg.stride, sr_mode="f32", clf_mode="cascade_int8",
                calib_patches=calib, cascade_escalate_frac=cfg.frac,
                cascade_escalate_score="vote_frac",
                cascade_guard_threshold=cfg.guard, device=dev)

        p_src = build(edsr_src, vgg_src.network())
        p_dst = build(edsr_dst, vgg_dst.network())
        with torch.inference_mode():
            sr_a, cls_a, conf_a = p_src(batch, n_valid=cfg.batch)
            before = dict(total)
            sr_b, cls_b, conf_b = main_path(lambda: p_dst(batch,
                                                          n_valid=cfg.batch))
            served = {k: total[k] - before[k] for k in total}
            sr_err = float((sr_b[:2] - plain_edsr(edsr_dst, batch[:2]))
                           .abs().max())
            srq = p_dst.pre_quant(sr_b)
            with on_plain_twins():
                cls_p, conf_p = p_dst.cascade_votes(srq, cfg.batch)
        check(torch.equal(sr_a, sr_b) and torch.equal(cls_a, cls_b)
              and torch.equal(conf_a, conf_b),
              "the shipped mode on the imported weights differs from the "
              "source's")
        check(sr_err <= SR_ATOL, f"shipped mode SR vs plain chained EDSR: "
                                 f"{sr_err}")
        check(torch.equal(cls_p, cls_b) and torch.equal(conf_p, conf_b),
              "the imported cascade on K1's and K3's twins differs")
        check(all(served[k] > 0 for k in ("conv3x3_int8_requant",
                                           "conv3x3_bias_act", "block1_int8")),
              f"the shipped mode launched {served}")
        print(f"[h5] the shipped mode (f32 SR -> cascade_int8 vote_frac "
              f"{cfg.frac}, guard {cfg.guard}) on the imported EDSR and "
              f"VGG16, one batch of {cfg.batch}: classes {cls_b.tolist()} and "
              f"confidences torch.equal to the source weights'; launches "
              f"{served}; SR vs plain chained EDSR max|err| {sr_err:.3g} "
              f"(SR_ATOL {SR_ATOL}); the cascade on K1's and K3's twins equal")
        del p_src, p_dst, srq

        # ---- cli convert: checkpoint -> .h5 -> checkpoint, the four ----
        ck = os.path.join(work, "ck")
        sources = {"edsr": src.save(ck, "src"), "srcnn":
                   outs["SRCNN 96/32"][0].save(ck, "src"),
                   "vgg16": vgg_src.save(ck, "src"),
                   "esrgan": esrc.save(ck, "src")}
        args = {"edsr": ["--scale", str(cfg.scale), "--blocks",
                         str(cfg.blocks), "--filters", str(cfg.filters)],
                "srcnn": [], "vgg16": ["--input-hw", str(s.patch)],
                "esrgan": ["--scale", "4", "--growth", str(s.growth),
                           "--rrdb-blocks", str(s.rrdb), "--patch-size",
                           str(s.disc_hw // 4)]}
        out = subprocess.run(
            [sys.executable, "-m", "tpusr_torch.cli", "convert", "--model",
             "edsr", "--src", sources["edsr"], "--out",
             os.path.join(work, "h5c"), "--timestamp", "c1", *args["edsr"]],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"`python -m tpusr_torch.cli convert`: "
                                   f"{out.stderr[-400:]}")
        lines = []
        for model, ckpt in sources.items():
            if model == "edsr":
                h5_out = os.path.join(work, "h5c", "EDSR_x4_c1.h5")
            else:
                h5_out = cli_main(["convert", "--model", model, "--src", ckpt,
                                   "--out", os.path.join(work, "h5c"),
                                   "--timestamp", "c1", *args[model]])
            extra = []
            if model == "esrgan":
                h5_out, disc = h5_out
                extra = ["--disc", disc]
            back = cli_main(["convert", "--model", model, "--src", h5_out,
                             "--out", os.path.join(work, "ckc"),
                             "--timestamp", "c2", *args[model], *extra])
            same, n = checkpoint_leaves_equal(ckpt, back)
            check(same, f"convert {model}: the checkpoint after .h5 differs "
                        f"from the first")
            lines.append(f"{model} {n} tensors")
        print(f"[h5] `python -m tpusr_torch.cli convert` (EDSR, a subprocess) "
              f"and cli.main convert: checkpoint -> .h5 -> checkpoint, every "
              f"tensor of the last equal to the first: {', '.join(lines)}; "
              f"ESRGAN back through --disc")
        del esrc, edst, g_src, g_dst, outs, vgg_src, vgg_dst
        torch.cuda.empty_cache()

        # ---- train-esrgan --vgg19-weights <.h5> against the .npz ----
        es = ESRGANConfig()      # the command's generator (g8x4)
        vgg19 = VGG19Features(device=dev, key=seed + s.vgg_seed)
        v19_h5 = os.path.join(work, "vgg19_notop.h5")
        _, w_ms = host(lambda: write_vgg_notop(v19_h5, vgg19.vgg19))
        v19_npz = os.path.join(work, "vgg19.npz")
        np.savez(v19_npz, **backbone_arrays(vgg19.vgg19))
        c = CommandsSlice()
        data = os.path.join(work, "data")
        write_reference_dataset(data, c, seed + c.train_seed, dev, maps=True)
        first_metrics, lines = [], []
        for weights in (v19_h5, v19_npz):
            argv = ["train-esrgan", "--hr-dir", os.path.join(data, "HR"),
                    "--lr-dir", os.path.join(data, "LR"), "--scale", "4",
                    "--epochs", "1", "--out", os.path.join(
                        work, os.path.basename(weights) + "_run"),
                    "--vgg19-weights", weights]
            got_metrics = []

            def keep(orig):
                def step(trainer, *a, **k):
                    state, metrics = orig(trainer, *a, **k)
                    if not got_metrics:
                        got_metrics.append({n: v.detach().clone()
                                            for n, v in metrics.items()})
                    return state, metrics
                return step

            with (first_train_step() as first, split_sizes() as sp,
                  count_plain_calls() as plain,
                  patched(gan_mod.ESRGANTrainer, train_step=keep)):
                if weights == v19_h5:
                    n0 = INIT_K5["n"]
                    _, run_s = host(lambda: main_path(lambda: cli_main(argv)))
                    got = read_counts()
                    built = init_since(n0)
                else:
                    cli_main(argv)
            check(plain.n == 0, f"train-esrgan: plain twins on the card "
                                f"{plain.by_twin}")
            first_metrics.append(got_metrics[0])
            if weights == v19_h5:
                (sizes,) = sp.sizes
                want_k2 = k2_command_launches(
                    sizes, 16, 1, 2 * esrgan_launches(es.num_rrdb_blocks, 4) - 1,
                    esrgan_launches(es.num_rrdb_blocks, 4), True)
                # the models it builds: G, D and VGG19, then G and D drawn
                # anew by the fit
                check(got == launches_want(conv3x3_bias_act=want_k2,
                                           prng=built),
                      f"train-esrgan --vgg19-weights: launches {got}, "
                      f"expected {want_k2} K2 and {built} K5")
                tr, w, xb, yb = first.got
                check(equal_params(tr.vgg_params, dict(
                    vgg19.named_parameters())),
                      "train-esrgan: the trainer's VGG19 is not the .h5's")
                p = w["g_params"]
                line = command_step_against_twin(
                    "train-esrgan --vgg19-weights", gan_train_layers(GanSlice(
                        lr=xb.shape[1], scale=4, batch=xb.shape[0]),
                        es.growth_channels, es.num_rrdb_blocks), p,
                    lambda: tr._generate(p, xb),
                    lambda: tr.g_loss_components(
                        p, w["d_params"], w["d_spectral"], xb, yb)[0])
                del first.got, tr, w, xb, yb, p
        a, b = first_metrics
        check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
              "train-esrgan: the first step's losses with the .h5 differ from "
              "the .npz's")
        print(f"[h5] train-esrgan --scale 4 --epochs 1 --vgg19-weights <VGG19 "
              f"notop .h5 written by the port's codec> on {c.images} pairs of "
              f"{c.size}^2 in {run_s / 1e3:.1f} s: the trainer's VGG19 is the "
              f"file's, the first step's losses "
              + ", ".join(f"{k} {float(v):.6g}" for k, v in a.items())
              + f" equal to a run on the same weights as .npz; K2 "
              f"{got['conv3x3_bias_act']} launches; {line}")

        # ---- the ImageNet tool: a VGG16 notop .h5 -> .npz ----
        vgg16 = VGG16Classifier(num_classes=2, device=dev,
                                key=seed + s.notop_seed)
        v16_h5 = os.path.join(work, "vgg16_notop.h5")
        write_vgg_notop(v16_h5, vgg16.vgg16)
        v16_npz = os.path.join(work, "vgg16_imagenet.npz")
        out = subprocess.run(
            [sys.executable, "-m", "tpusr_torch.tools.imagenet_weights",
             "--arch", "vgg16", "--src", v16_h5, "--out", v16_npz],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        check(out.returncode == 0 and "validated vgg16 (13 conv layers)"
              in out.stdout, f"imagenet_weights: {out.stderr[-400:]}")
        want = backbone_arrays(vgg16.vgg16)
        with np.load(v16_npz) as z:
            check(set(z.files) == set(want) | {"__arch__"}
                  and all(np.array_equal(z[k], v) for k, v in want.items()),
                  "imagenet_weights: the .npz differs from the .h5's arrays")
        print(f"[h5] `python -m tpusr_torch.tools.imagenet_weights --arch "
              f"vgg16` on a VGG16 notop .h5 ({os.path.getsize(v16_h5) / 1e6:.1f}"
              f" MB): validated, the .npz's 26 arrays equal to the file's")
        files += [("VGG19 notop", v19_h5, w_ms),
                  ("VGG16 notop", v16_h5, None)]
        for tag, path, w_ms in files:
            # read: the codec opens the file and reads every layer's
            # weights (keras_layer_weights), as each importer does first
            _, r_ms = host(lambda: keras_import.keras_layer_weights(path))
            print(f"[h5] {card}: {tag}: {os.path.getsize(path) / 1e6:.2f} MB, "
                  f"write {'-' if w_ms is None else f'{w_ms:.1f}'} ms, read "
                  f"{r_ms:.1f} ms (host clock)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ms = (time.perf_counter() - t_phase) * 1e3
    print(f"[h5] {card}: phase_h5 {ms:.0f} ms; launches under h5 {total}")
    check(all(total[k] > 0 for k in ("conv3x3_int8_requant",
                                     "conv3x3_bias_act", "block1_int8")),
          f"phase_h5: K1, K2 and K3 must each launch: {total}")
    return {"launches": total, "ms": ms}


# -------------------------------------------------------------------- orbax

ORBAX_FIXTURES = os.path.join(REPO, "tests", "data", "orbax")
FIXTURE_NAMES = ("srcnn", "edsr_x2", "vgg16", "esrgan_x2")


@dataclass(frozen=True)
class OrbaxSlice:
    """``phase_orbax``'s sizes: the committed JAX-written fixtures
    (``tests/data/orbax``) restored on the card; every facade at full width
    (EDSR x4 16x64 and VGG16 with its 256-unit head, each after
    ``steps`` training steps with all its layers training, so that Adam's
    moments are not zero; ESRGAN g32x23 x4 with the discriminator at 96^2;
    SRCNN 96/32) through the port's Orbax writer and reader."""
    steps: int = 3
    batch: int = 8
    patch: int = 96              # VGG16's input, SRCNN's
    edsr_lr: int = 48            # EDSR x4 training patches: LR 48^2
    growth: int = 32
    rrdb: int = 23
    disc_hw: int = 96


def fixture_state(name: str, arch: dict, dev):
    """(the port's initial state for a fixture's architecture, forward of
    a state on x) on ``dev``, as ``tests/test_torch_orbax.py`` builds
    them."""
    from torch.func import functional_call

    from tpusr_torch.models import EDSR, SRCNN, VGG16Classifier
    from tpusr_torch.models.esrgan import ESRGANDiscriminator, ESRGANGenerator
    from tpusr_torch.models.vgg import VGG19Features
    from tpusr_torch.train import (ClassifierTrainer, ESRGANTrainer,
                                   SupervisedSRTrainer)

    if name == "esrgan_x2":
        g = ESRGANGenerator(scale_factor=arch["scale_factor"],
                            growth_channels=arch["growth_channels"],
                            num_rrdb_blocks=arch["num_rrdb_blocks"],
                            base_filters=arch["base_filters"], device=dev)
        d = ESRGANDiscriminator(device=dev)
        tr = ESRGANTrainer(g, d, VGG19Features(
            widths=tuple(arch["vgg19_widths"]), device=dev), device=dev)
        return tr.init_state(), lambda st, x: functional_call(
            g, st.g_params, (x,))
    if name == "srcnn":
        m = SRCNN(f1=arch["f1"], f2=arch["f2"], device=dev)
        tr = SupervisedSRTrainer(m, 1e-3, device=dev)
    elif name == "edsr_x2":
        m = EDSR(scale_factor=arch["scale_factor"], channels=arch["channels"],
                 num_res_blocks=arch["num_res_blocks"],
                 num_filters=arch["num_filters"],
                 res_scaling=arch["res_scaling"], device=dev)
        tr = SupervisedSRTrainer(m, 1e-3, clipnorm=1.0, device=dev)
    else:
        m = VGG16Classifier(num_classes=arch["num_classes"],
                            dense_units=arch["dense_units"],
                            widths=tuple(arch["widths"]),
                            dropout_rate=arch["dropout_rate"], device=dev)
        tr = ClassifierTrainer(m, 1e-3, device=dev,
                               trainable_predicate=lambda p: p[0] != "vgg16")
    return tr.init_state(), lambda st, x: functional_call(m, st.params, (x,))


def state_tensors(state) -> dict:
    """Every leaf of a trainer state by path (``checkpoint._flatten``)."""
    from tpusr_torch.train.checkpoint import _flatten
    return _flatten(state)


def states_equal(a, b) -> tuple[bool, int]:
    """(every leaf of two trainer states equal: tensors torch.equal on
    the same device and dtype, numbers ==; the leaves compared)."""
    la, lb = state_tensors(a), state_tensors(b)
    same = la.keys() == lb.keys()
    for k in la if same else ():
        x, y = la[k], lb[k]
        if isinstance(x, torch.Tensor):
            same &= (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                     and x.device == y.device and torch.equal(x, y))
        else:
            same &= x == y
    return bool(same), len(la)


def rle_raw_frame_bytes(data: bytes) -> int:
    """The size of a zstd frame of ``data`` in RLE and raw blocks alone
    (``train/zstd.py``'s frame header; each 128 KiB block a 3-byte header
    and one byte if it is one value, else the block)."""
    n = len(data)
    size = 5 + (1 if n < 256 else 2 if n < 65792 else 4 if n < 1 << 32 else 8)
    for i in range(0, max(n, 1), 1 << 17):
        b = np.frombuffer(data[i:i + (1 << 17)], np.uint8)
        size += 3 + (1 if len(b) and (b == b[0]).all() else len(b))
    return size


def phase_orbax(s: OrbaxSlice, cfg: Slice, dev, seed: int, sync,
                card: str) -> dict:
    """The JAX package's Orbax checkpoints in the port (``train/zstd.py``,
    ``ocdbt.py``, ``zarr.py``, ``orbax.py``, ``checkpoint.py``, ``bridge``):
    (a) the committed JAX-written fixtures restored onto the card, each
    network's output on the fixture's input against JAX's stored one; (b)
    each facade's state at full width saved by the port's writer and
    restored, every tensor torch.equal (the VGG16 and EDSR states after
    training steps, their moments not zero); (c) the shipped mode served
    on the restored EDSR and VGG16 against the source's (K1, K2, K3 each
    held to its twin); (d) ``python -m tpusr_torch.cli pipeline`` and
    ``train-edsr --resume`` on the written directories; (e) every save and
    restore time and the zstd decode rate. Each main-path run is driven
    with the launch counts set to 0 just before it and read just after,
    summed under ``orbax``. Returns those launches."""
    import shutil
    import tempfile

    from tpusr_torch.core.patches import patchify
    from tpusr_torch.models.api import (EDSR as EDSRFacade, ESRGAN,
                                        FineTunedVGG16, SRCNNModel)
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply
    from tpusr_torch.models.layers import pixel_shuffle
    from tpusr_torch.pipeline import make_serving_pipeline
    from tpusr_torch.train import ocdbt, restore_checkpoint, zstd

    t_phase = time.perf_counter()
    total = {k: 0 for k in read_counts()}

    def main_path(fn):
        reset_counts()
        out = fn()
        sync()
        for k, v in read_counts().items():
            total[k] += v
        return out

    def host(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def dir_bytes(path: str) -> int:
        return sum(os.path.getsize(os.path.join(r, f))
                   for r, _d, fs in os.walk(path) for f in fs)

    # ---- (a) the committed fixtures, written by JAX ----
    io = np.load(os.path.join(ORBAX_FIXTURES, "outputs.npz"))
    lines = []
    for name in FIXTURE_NAMES:
        with open(os.path.join(ORBAX_FIXTURES, f"{name}.meta.json")) as f:
            arch = json.load(f)["arch"]
        template, fwd = fixture_state(name, arch, dev)
        st, r_ms = host(lambda: restore_checkpoint(ORBAX_FIXTURES, name,
                                                   template))
        check(all(v.device.type == "cuda" for v in state_tensors(st).values()
                  if isinstance(v, torch.Tensor)),
              f"orbax {name}: a restored tensor is not on the card")
        x = torch.as_tensor(io[f"{name}_x"], device=dev)
        with torch.inference_mode():
            y = main_path(lambda: fwd(st, x))
        err = float((y.cpu() - torch.as_tensor(io[f"{name}_y"])).abs().max())
        tol = TRUNK_F32_ATOL if name == "vgg16" else SR_ATOL
        check(err <= tol, f"orbax {name}: the restored network's output is "
                          f"{err} from JAX's (tolerance {tol})")
        lines.append(f"{name} {tuple(y.shape)} max|err| {err:.3g} (restore "
                     f"{r_ms:.1f} ms)")
    print(f"[orbax] the committed JAX-written checkpoints (tests/data/orbax, "
          f"two JAX steps each, Adam's moments not zero) restored onto the "
          f"card, each network on the fixture's input against JAX's stored "
          f"output (SR_ATOL {SR_ATOL}, VGG16 TRUNK_F32_ATOL "
          f"{TRUNK_F32_ATOL}): " + "; ".join(lines))

    work = tempfile.mkdtemp(prefix="chip_smoke_orbax_")
    rng = np.random.default_rng(seed + 24)
    times = []                  # (tag, MB on disk, save ms, restore ms)
    try:
        # ---- (b) full width: train a few steps, save, restore ----
        def round_trip(tag, facade, name, template, state):
            path, w_ms = host(lambda: facade.save(work, name))
            back, r_ms = host(lambda: restore_checkpoint(
                work, os.path.basename(path), template))
            same, n = states_equal(back, state)
            check(same, f"orbax {tag}: the restored state differs from the "
                        f"saved one")
            times.append((tag, dir_bytes(path) / 1e6, w_ms, r_ms))
            return path, back, n

        src = EDSRFacade(device=dev)
        src.setup_model(scale_factor=cfg.scale, num_res_blocks=cfg.blocks,
                        num_filters=cfg.filters)
        for _ in range(s.steps):
            x = torch.as_tensor(rng.random((s.batch, s.edsr_lr, s.edsr_lr, 3),
                                           dtype=np.float32), device=dev)
            y = torch.as_tensor(rng.random(
                (s.batch, s.edsr_lr * cfg.scale, s.edsr_lr * cfg.scale, 3),
                dtype=np.float32), device=dev)
            src.state, _ = src.trainer.train_step(src.state, x, y)
        src.trained = True
        check(all(bool(v.any()) for v in src.state.opt_state["mu"].values()),
              "orbax EDSR: a moment is zero after training")
        edsr_path, edsr_back, n_edsr = round_trip(
            f"EDSR x{cfg.scale} {cfg.blocks}x{cfg.filters} TrainState",
            src, "edsr", src.trainer.init_state(), src.state)

        vsrc = FineTunedVGG16(device=dev)
        vsrc.setup_model(input_shape=(s.patch, s.patch, 3),
                         base_trainable=True, train_last_n_layers=0)
        for step in range(s.steps):
            x = torch.as_tensor(rng.random((s.batch, s.patch, s.patch, 3),
                                           dtype=np.float32), device=dev)
            y = torch.as_tensor(rng.integers(0, 2, s.batch, dtype=np.int32),
                                device=dev)
            vsrc.state, _ = vsrc.trainer.train_step(vsrc.state, x, y, step)
        vsrc.trained = True
        check(len(vsrc.state.opt_state["mu"]) == len(vsrc.state.params)
              and all(bool(v.any()) for v in vsrc.state.opt_state["nu"]
                      .values()),
              "orbax VGG16: not every parameter has moments that are not "
              "zero")
        vgg_path, vgg_back, n_vgg = round_trip(
            "VGG16 TrainState (every layer training)", vsrc, "vgg16",
            vsrc.trainer.init_state(), vsrc.state)

        gsrc = ESRGAN(device=dev)
        gkw = dict(scale_factor=4, growth_channels=s.growth,
                   num_rrdb_blocks=s.rrdb,
                   input_shape=(s.disc_hw // 4, s.disc_hw // 4, 3),
                   output_shape=(s.disc_hw, s.disc_hw, 3))
        gsrc.setup_model(**gkw)
        gsrc.trained = True
        _, _, n_gan = round_trip(
            f"ESRGAN g{s.growth}x{s.rrdb} x4 GANState", gsrc, "esrgan",
            gsrc.trainer.init_state(), gsrc.state)
        del gsrc
        ssrc = SRCNNModel(device=dev)
        ssrc.setup_model()
        ssrc._trained = True
        _, _, n_srcnn = round_trip("SRCNN 96/32 TrainState", ssrc, "srcnn",
                                   ssrc.trainer.init_state(), ssrc.state)
        print(f"[orbax] at full width, saved by the port's writer and "
              f"restored: EDSR x{cfg.scale} after {s.steps} steps ({n_edsr} "
              f"leaves), VGG16 after {s.steps} steps with every layer "
              f"training ({n_vgg}), ESRGAN g{s.growth}x{s.rrdb} with its "
              f"discriminator ({n_gan}), SRCNN ({n_srcnn}): every tensor "
              f"torch.equal on the card, counts and rates equal")

        # ---- the zstd decode rate: every chunk of the VGG16 directory ----
        items = ocdbt.read(vgg_path)
        frames = [v for k, v in items.items()
                  if not k.endswith(".zarray") and len(v) > 4
                  and v[:4] == b"\x28\xb5\x2f\xfd"]
        chunks = []

        def decode_all():
            chunks[:] = [zstd.decompress(f, device=dev) for f in frames]
        _, d_ms = host(decode_all)
        in_mb = sum(len(f) for f in frames) / 1e6
        out_bytes = sum(map(len, chunks))
        # the encoder's Huffman literals against RLE and raw blocks alone,
        # on the VGG16 chunks' first 32 MB
        enc = []
        for c_ in chunks:
            if sum(map(len, enc)) < 32e6:
                enc.append(c_)
        huf, e_ms = host(lambda: sum(len(zstd.compress(c_)) for c_ in enc))
        plain = sum(rle_raw_frame_bytes(c_) for c_ in enc)
        enc_mb = sum(map(len, enc)) / 1e6
        e_frames = []            # the host's CPU: the EDSR's first 4 MB
        for k, v in sorted(ocdbt.read(edsr_path).items()):
            if not k.endswith(".zarray") and sum(map(len, e_frames)) < 4e6:
                e_frames.append(v)
        _, c_ms = host(lambda: [zstd.decompress(f, device="cpu")
                                for f in e_frames])
        c_mb = sum(len(f) for f in e_frames) / 1e6

        # ---- (c) the shipped mode on the restored EDSR and VGG16 ----
        from tpusr_torch.models.api import module_with_params
        edsr_src = src.network()
        edsr_dst = module_with_params(src.module, edsr_back.params)
        vgg_src = vsrc.network()
        vgg_dst = module_with_params(vsrc.module, vgg_back.params)
        gain = rng.uniform(0.05, 1.0, (cfg.batch + 4, 1, 1, 1)).astype(
            np.float32)
        imgs = torch.as_tensor(rng.random((cfg.batch + 4, cfg.lr, cfg.lr, 3),
                                          dtype=np.float32) * gain, device=dev)
        batch, calib_lr = imgs[:cfg.batch], imgs[cfg.batch:]
        fn, r = make_fused_sr_apply(edsr_src)
        with torch.inference_mode():
            calib = patchify(pixel_shuffle(fn(calib_lr), r), cfg.patch,
                             cfg.stride)
            calib = calib.reshape((-1,) + calib.shape[2:])[:64]

        def build(edsr, vgg):
            return make_serving_pipeline(
                edsr, vgg, (cfg.lr, cfg.lr), cfg.scale, patch=cfg.patch,
                stride=cfg.stride, sr_mode="f32", clf_mode="cascade_int8",
                calib_patches=calib, cascade_escalate_frac=cfg.frac,
                cascade_escalate_score="vote_frac",
                cascade_guard_threshold=cfg.guard, device=dev)

        p_src, p_dst = build(edsr_src, vgg_src), build(edsr_dst, vgg_dst)
        with torch.inference_mode():
            sr_a, cls_a, conf_a = p_src(batch, n_valid=cfg.batch)
            before = dict(total)
            sr_b, cls_b, conf_b = main_path(lambda: p_dst(batch,
                                                          n_valid=cfg.batch))
            served = {k: total[k] - before[k] for k in total}
            with k2_against_twin() as k2c:
                edsr_dst(batch[:2])
            sr_err = float((sr_b[:2] - plain_edsr(edsr_dst, batch[:2]))
                           .abs().max())
            srq = p_dst.pre_quant(sr_b)
            with on_plain_twins():
                cls_p, conf_p = p_dst.cascade_votes(srq, cfg.batch)
        check(torch.equal(sr_a, sr_b) and torch.equal(cls_a, cls_b)
              and torch.equal(conf_a, conf_b),
              "orbax: the shipped mode on the restored weights differs from "
              "the source's")
        check(len(k2c.rows) == 2 * cfg.blocks + 5 and all(r[4] for r in
                                                          k2c.rows),
              f"orbax EDSR: K2 beyond its bound against the twin at "
              f"{[r[0] for r in k2c.rows if not r[4]]}")
        check(sr_err <= SR_ATOL, f"orbax: shipped mode SR vs plain chained "
                                 f"EDSR: {sr_err}")
        check(torch.equal(cls_p, cls_b) and torch.equal(conf_p, conf_b),
              "orbax: the restored cascade on K1's and K3's twins differs")
        check(all(served[k] > 0 for k in ("conv3x3_int8_requant",
                                           "conv3x3_bias_act", "block1_int8")),
              f"orbax: the shipped mode launched {served}")
        print(f"[orbax] the shipped mode (f32 SR -> cascade_int8 vote_frac "
              f"{cfg.frac}, guard {cfg.guard}) on the restored EDSR and "
              f"VGG16, one batch of {cfg.batch}: classes {cls_b.tolist()} and "
              f"confidences torch.equal to the source weights'; launches "
              f"{served}; the restored EDSR's {len(k2c.rows)} K2 launches "
              f"within their bound of the twin; SR vs plain chained EDSR "
              f"max|err| {sr_err:.3g}; the cascade on K1's and K3's twins "
              f"equal")
        # ---- (d) the commands on the written directories ----
        # pipeline's facade trains VGG16's head alone: the restored weights
        # in such a state, whose frozen moments are zero
        frozen = FineTunedVGG16(device=dev)
        frozen.setup_model(input_shape=(s.patch, s.patch, 3))
        with torch.no_grad():
            for k, v in frozen.state.params.items():
                v.copy_(vgg_back.params[k])
        frozen.trained = True
        v_path = frozen.save(work, "vgg16_frozen")
        del p_src, p_dst, srq, edsr_src, vgg_src, vgg_dst, edsr_back
        del vgg_back, vsrc, frozen
        torch.cuda.empty_cache()
        c = CommandsSlice()
        data = os.path.join(work, "data")
        write_reference_dataset(data, c, seed + c.train_seed, dev, maps=True)
        cmds = {
            "pipeline": ["pipeline", "--lr-dir", os.path.join(data, "LR"),
                         "--hr-dir", os.path.join(data, "HR"), "--class-map",
                         os.path.join(data, "class_map.pkl"), "--out",
                         os.path.join(work, "pipe"), "--batch-size", "4",
                         "--classic-methods", "bicubic", "--edsr-ckpt",
                         edsr_path, "--vgg16-ckpt", v_path],
            "train-edsr": ["train-edsr", "--hr-dir", os.path.join(data, "HR"),
                           "--lr-dir", os.path.join(data, "LR"), "--scale",
                           str(cfg.scale), "--epochs", "1", "--out",
                           os.path.join(work, "resumed"), "--resume",
                           edsr_path]}
        run_lines = []
        for cmd, argv in cmds.items():
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "tpusr_torch.cli",
                                  *argv], cwd=REPO, capture_output=True,
                                 text=True, timeout=600)
            run_s = time.perf_counter() - t0
            check(out.returncode == 0, f"`python -m tpusr_torch.cli {cmd}` "
                                       f"on the Orbax directories: "
                                       f"{out.stderr[-600:]}")
            run_lines.append(f"{cmd} {run_s:.1f} s")
        with open(os.path.join(work, "pipe", "pipeline_results.json")) as f:
            res = json.load(f)
        check(list(res) == ["bicubic", "edsr"] and all(
            0 <= r["accuracy"] <= 1 and math.isfinite(r["psnr_mean"])
            for r in res.values()), f"orbax pipeline: {res}")
        (resumed,) = [d for d in os.listdir(os.path.join(work, "resumed"))
                      if d.startswith("EDSR_") and "." not in d]
        count = int(checkpoint_leaves(os.path.join(
            work, "resumed", resumed))[("opt_state", "count")])
        check(count > s.steps, f"train-edsr --resume: Adam's count {count} "
                               f"did not go on from {s.steps}")
        print(f"[orbax] `python -m tpusr_torch.cli pipeline --edsr-ckpt "
              f"<dir> --vgg16-ckpt <dir>` on {c.images} pairs of {c.size}^2: "
              f"edsr psnr {res['edsr']['psnr_mean']:.2f} dB, accuracy "
              f"{res['edsr']['accuracy']:.3f}; `train-edsr --resume <dir> "
              f"--epochs 1`: Adam's count {s.steps} -> {count}; "
              + ", ".join(run_lines) + " (subprocesses, host clock)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for tag, mb, w_ms, r_ms in times:
        print(f"[orbax] {card}: {tag}: {mb:.2f} MB on disk, save "
              f"{w_ms:.0f} ms, restore {r_ms:.0f} ms (host clock, "
              f"synchronised; the restore's zstd on the card)")
    print(f"[orbax] {card}: zstd decode of the VGG16 directory's "
          f"{len(frames)} frames: {in_mb:.1f} MB -> {out_bytes / 1e6:.1f} MB "
          f"in {d_ms:.0f} ms on the card ({out_bytes / 1e3 / d_ms:.0f} MB/s "
          f"decoded); the EDSR directory's {c_mb:.1f} MB on the host's CPU "
          f"in {c_ms:.0f} ms ({c_mb * 1e3 / c_ms:.1f} MB/s compressed)")
    print(f"[orbax] {card}: zstd encode of {len(enc)} VGG16 chunks, "
          f"{enc_mb:.1f} MB: {huf / 1e6:.2f} MB with Huffman literals in "
          f"{e_ms:.0f} ms on the host ({enc_mb * 1e3 / e_ms:.1f} MB/s); RLE "
          f"and raw blocks alone {plain / 1e6:.2f} MB "
          f"({100 * (plain - huf) / plain:.1f}% more)")
    ms = (time.perf_counter() - t_phase) * 1e3
    print(f"[orbax] {card}: phase_orbax {ms:.0f} ms; launches under orbax "
          f"{total}")
    check(all(total[k] > 0 for k in ("conv3x3_int8_requant",
                                     "conv3x3_bias_act", "block1_int8")),
          f"phase_orbax: K1, K2 and K3 must each launch: {total}")
    return {"launches": total, "ms": ms}


# --------------------------------------------------------------- preprocess

VIDEO_FIXTURES = os.path.join(REPO, "tests", "data", "video")
MPEG4_FIXTURES = os.path.join(REPO, "tests", "data", "mpeg4")
WEBM_FIXTURES = os.path.join(REPO, "tests", "data", "webm")


@dataclass(frozen=True)
class PreprocessSlice:
    """``preprocess`` on the committed clips (``tests/data/video``): a clip
    at the size users record (1280x720 MJPEG, 10 fps, 40 frames of a print
    moving over the bed) with ``--hr-size 512`` and without, the 59x80 clip
    whose odd crop is trimmed (``--predictions``), the same print as
    MPEG-4 Part 2 in MP4 (``tests/data/mpeg4``, what ``cv2.VideoWriter``
    writes with ``mp4v``), as VP8 in WebM (its first 16 frames) and as
    ``mp4v`` in Matroska (``tests/data/webm``) with ``--hr-size 512``, then
    ``train-edsr --scale 2`` for ``edsr_epochs`` on the 512^2 pairs."""
    clip: str = "print_720p.avi"
    mp4_clip: str = "print_720p.mp4"
    webm_clip: str = "print_720p.webm"
    mkv_clip: str = "print_720p.mkv"
    odd_clip: str = "odd_59x80.avi"
    hr_size: int = 512
    edsr_epochs: int = 1
    frame_stride: int = 5     # the 720p frames held to cv2's hashes
    cpu_frames: tuple = (0, 10)   # degraded on the card and on the CPU
    seed: int = 900


def video_pattern(h: int, w: int, kind: str) -> np.ndarray:
    """``tests/data/video/make_fixtures.py``'s ``pattern``: the resize
    fixtures' inputs, rebuilt from integer arithmetic."""
    y = np.arange(h, dtype=np.uint64)[:, None, None]
    x = np.arange(w, dtype=np.uint64)[None, :, None]
    c = np.arange(3, dtype=np.uint64)[None, None, :]
    if kind == "noise":
        v = (x * np.uint64(2654435761) + y * np.uint64(40503)
             + c * np.uint64(97)) & np.uint64(0xFFFFFFFF)
        v ^= v >> np.uint64(13)
        v = (v * np.uint64(1274126177)) & np.uint64(0xFFFFFFFF)
        v ^= v >> np.uint64(16)
        return (v & np.uint64(255)).astype(np.uint8)
    t = (x * np.uint64(5) + y * np.uint64(3) + c * np.uint64(70)) % np.uint64(510)
    return np.abs(t.astype(np.int64) - 255).astype(np.uint8)


def _sha(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()
                          if isinstance(a, np.ndarray) else a).hexdigest()


def check_mpeg4_fixtures(p: PreprocessSlice, card: str) -> dict:
    """The MPEG-4 Part 2 reader's rate, count and every frame of each clip
    under ``tests/data/mpeg4`` (the 720p ``.mp4``, the small ``.mp4``,
    ``.mov`` and ``.avi`` clips, the hand-written stream) against what
    ``cv2.VideoCapture`` read (``manifest.json``), and the tools the decoder
    counted against the manifest's counts; then the host time of a
    1280x720 I-VOP and P-VOP (the whole clip decoded, best of 2, each VOP
    timed) and of the BGR conversion. Returns the times and the 720p frames
    that ``preprocess`` samples (one a second)."""
    import collections

    from tpusr_torch.data import mpeg4
    from tpusr_torch.data.video import open_video
    from tpusr_torch.pipeline.png import decode_png_u8

    with open(os.path.join(MPEG4_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["clips"]
    held, kept = 0, {}
    for name, entry in manifest.items():
        video = open_video(os.path.join(MPEG4_FIXTURES, name))
        check((len(video), video.fps) == (entry["frames"], entry["fps"]),
              f"{name}: {len(video)} frames at {video.fps} fps, cv2 reads "
              f"{entry['frames']} at {entry['fps']}")
        step = int(video.fps) if name == p.mp4_clip else 0
        for i, frame in enumerate(video.frames()):
            bgr = frame()
            check(_sha(bgr) == entry["sha256"][i],
                  f"{name} frame {i}: differs from cv2.VideoCapture's")
            if i in entry["png_frames"]:
                with open(os.path.join(MPEG4_FIXTURES,
                                       f"{name[:-4]}_f{i}.png"), "rb") as f:
                    twin = decode_png_u8(f.read())
                check(np.array_equal(twin, bgr[..., ::-1]),
                      f"{name} frame {i}: differs from its cv2 PNG")
            if step and i % step == 0:
                kept[i] = bgr
            held += 1
        check(dict(video.counts) == entry["counts"],
              f"{name}: the decoder met {dict(video.counts)}, the manifest "
              f"has {entry['counts']}")
    video = open_video(os.path.join(MPEG4_FIXTURES, p.mp4_clip))
    best = None
    for _ in range(2):
        dec, ms = mpeg4.Mpeg4Decoder(video.vol), collections.defaultdict(list)
        for i, sample in enumerate(video.samples):
            t0 = time.perf_counter()
            planes = dec.decode(sample)
            ms["I" if i in video.intra else "P"].append(
                (time.perf_counter() - t0) * 1e3)
        run = {k: sum(v) / len(v) for k, v in ms.items()}
        best = run if best is None else {k: min(best[k], run[k])
                                         for k in run}
    conv = min(host_ms(lambda: mpeg4.to_bgr(planes, video.vol), lambda: None)
               for _ in range(2))
    sizes = {k: float(np.mean([len(video.samples[i])
                               for i in range(len(video.samples))
                               if (i in video.intra) == (k == "I")]))
             for k in "IP"}
    print(f"[mpeg4] {card}: {held} frames of {len(manifest)} MPEG-4 Part 2 "
          f"clips (mp4v in .mp4/.mov, XVID/DIVX/FMP4 in .avi, a hand-written "
          f"stream) equal to cv2.VideoCapture's by sha256, rates and counts "
          f"equal; {p.mp4_clip} (1280x720, {len(video.intra)} I-VOPs, "
          f"{len(video) - len(video.intra)} P-VOPs): an I-VOP decodes in "
          f"{best['I']:.1f} ms, a P-VOP in {best['P']:.1f} ms, the BGR "
          f"conversion {conv:.1f} ms a frame (host, best of 2); "
          f"{sizes['I']:.0f} bytes an I-VOP, {sizes['P']:.0f} a P-VOP")
    return {"frames_held": held, "i_vop_ms": best["I"],
            "p_vop_ms": best["P"], "convert_ms": conv,
            "i_vop_bytes": sizes["I"], "p_vop_bytes": sizes["P"],
            "kept": kept}


def _vp8_timed_frames(video, ms: dict):
    """The BGR frames of a ``vp8video.Vp8Video``, decoded in order by one
    decoder with each decode (``ms["key"]``, ``ms["inter"]``) and each
    conversion (``ms["convert"]``) timed on the host clock."""
    from tpusr_torch.data import vp8video

    dec = vp8video.Vp8Decoder()
    for sample in video.samples:
        t0 = time.perf_counter()
        planes = dec.decode(sample)
        ms["inter" if sample[0] & 1 else "key"].append(
            (time.perf_counter() - t0) * 1e3)
        if planes is not None:
            t0 = time.perf_counter()
            bgr = vp8video.to_bgr(planes, dec.width, dec.height,
                                  dec.full_range)
            ms["convert"].append((time.perf_counter() - t0) * 1e3)
            yield bgr
    video.counts.update(dec.counts)


def check_webm_fixtures(p: PreprocessSlice, card: str) -> dict:
    """Every Matroska/WebM fixture under ``tests/data/webm`` (the 720p VP8
    ``.webm`` and ``mp4v`` ``.mkv``, the small clips ``cv2.VideoWriter``
    wrote, their crafted layouts, the hand-written VP8 streams): the rate,
    the count, every frame by sha256 and the tools the decoders counted
    against ``manifest.json`` (cv2's reading); the 720p VP8 clip with each
    frame's decode and conversion timed. Returns the times and, per print
    clip, the frames ``preprocess`` samples (one a second)."""
    from tpusr_torch.data.video import open_video

    with open(os.path.join(WEBM_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["clips"]
    held, kept = 0, {p.webm_clip: {}, p.mkv_clip: {}}
    ms = {"key": [], "inter": [], "convert": []}
    for name, entry in manifest.items():
        video = open_video(os.path.join(WEBM_FIXTURES, name))
        check((len(video), video.fps) == (entry["frames"], entry["fps"]),
              f"{name}: {len(video)} frames at {video.fps} fps, cv2 reads "
              f"{entry['frames']} at {entry['fps']}")
        step = int(video.fps) if name in kept else 0
        frames = (_vp8_timed_frames(video, ms) if name == p.webm_clip
                  else (f() for f in video.frames()))
        for i, bgr in enumerate(frames):
            check(_sha(bgr) == entry["sha256"][i],
                  f"{name} frame {i}: differs from cv2.VideoCapture's")
            if step and i % step == 0:
                kept[name][i] = bgr
            held += 1
        met = dict(getattr(video, "counts", {}))    # MJPEG counts nothing
        check(met == entry["counts"], f"{name}: the decoder met {met}, the "
                                      f"manifest has {entry['counts']}")
    video = open_video(os.path.join(WEBM_FIXTURES, p.webm_clip))
    out = {k: float(np.mean(v)) for k, v in ms.items()}
    sizes = {k: float(np.mean([len(s) for s in video.samples
                               if bool(s[0] & 1) == (k == "inter")]))
             for k in ("key", "inter")}
    print(f"[webm] {card}: {held} frames of {len(manifest)} Matroska/WebM "
          f"files (VP8, mp4v and MJPEG from cv2.VideoWriter, their crafted "
          f"layouts, hand-written VP8 streams) equal to cv2.VideoCapture's "
          f"by sha256, rates and tool counts equal; {p.webm_clip} (VP8, "
          f"1280x720, {len(ms['key'])} key frames, {len(ms['inter'])} "
          f"interframes): a key frame decodes in {out['key']:.1f} ms, an "
          f"interframe in {out['inter']:.1f} ms, the BGR conversion "
          f"{out['convert']:.1f} ms a frame (host, mean); {sizes['key']:.0f} "
          f"bytes a key frame, {sizes['inter']:.0f} an interframe")
    return {"frames_held": held, "key_ms": out["key"],
            "inter_ms": out["inter"], "convert_ms": out["convert"],
            "key_bytes": sizes["key"], "inter_bytes": sizes["inter"],
            "kept": kept}


def check_video_fixtures(p: PreprocessSlice, dev, sync, card: str) -> dict:
    """The JPEG encoder's bytes, the AVI reader's rate, count and frames,
    and ``resize_u8`` on the card against what OpenCV wrote into
    ``tests/data/video`` (``manifest.json``); then the MPEG-4 fixtures
    (``check_mpeg4_fixtures``)."""
    from tpusr_torch.data import avi
    from tpusr_torch.data._cv_ops import resize_u8
    from tpusr_torch.pipeline.jpeg_encode import encode_jpeg_u8
    from tpusr_torch.pipeline.png import decode_png_u8

    with open(os.path.join(VIDEO_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)

    def png(name):
        with open(os.path.join(VIDEO_FIXTURES, name), "rb") as f:
            return decode_png_u8(f.read())

    n_enc = 0
    for size, entry in manifest["encode"].items():
        rgb = png(f"enc_{size}.png")
        check(_sha(rgb) == entry["input_sha256"],
              f"encoder fixture {size}: the input PNG reads differently")
        for q, digest in entry["jpeg_sha256"].items():
            got = encode_jpeg_u8(rgb, int(q))
            check(_sha(got) == digest,
                  f"JPEG encoder at {size} q{q}: bytes differ from "
                  f"cv2.imencode's")
            n_enc += 1
    big = png("enc_256x256.png")
    enc_ms = min(host_ms(lambda: encode_jpeg_u8(big, 40), sync)
                 for _ in range(3))
    print(f"[preprocess] {card}: JPEG encoder equal to cv2.imencode byte for "
          f"byte on {n_enc} fixtures (5 sizes x q 1, 20, 37, 59, 75, 100); "
          f"256^2 at q 40 in {enc_ms:.1f} ms (host)")

    frames_held = 0
    for name, entry in manifest["clips"].items():
        video = avi.read_avi(os.path.join(VIDEO_FIXTURES, name))
        check((len(video), video.fps) == (entry["frames"], entry["fps"]),
              f"{name}: {len(video)} frames at {video.fps} fps, cv2 reads "
              f"{entry['frames']} at {entry['fps']}")
        idx = (range(0, len(video), p.frame_stride) if len(video) > 30
               else range(len(video)))
        idx = sorted(set(idx) | set(entry["png_frames"]))
        for i in idx:
            frame = video.frame(i)
            check(_sha(frame) == entry["sha256"][i],
                  f"{name} frame {i}: differs from cv2.VideoCapture's")
            if i in entry["png_frames"]:
                twin = png(f"{name[:-4]}_f{i}.png")
                check(np.array_equal(twin, frame[..., ::-1]),
                      f"{name} frame {i}: differs from its cv2 PNG")
            frames_held += 1
    video = avi.read_avi(os.path.join(VIDEO_FIXTURES, p.clip))
    decode_ms = min(host_ms(lambda: video.frame(0), sync) for _ in range(2))
    print(f"[preprocess] {card}: AVI reader: rate and frame count of "
          f"{len(manifest['clips'])} clips equal to cv2's, {frames_held} frames "
          f"equal to cv2.VideoCapture's (FFmpeg) by sha256; a 1280x720 frame "
          f"decodes in {decode_ms:.0f} ms (host)")

    counts = []
    for case in manifest["resize"]:
        img = video_pattern(*case["in"], case["kind"])
        check(_sha(img) == case["input_sha256"],
              f"resize fixture {case['in']}: the pattern differs")
        got = resize_u8(torch.from_numpy(img).to(dev), tuple(case["out"]),
                        case["method"]).cpu().numpy()
        if case["port_mismatch"]:
            want = png(case["png"])[..., ::-1]
            n = int((got != want).sum())
            d = int(np.abs(got.astype(int) - want).max())
            check(n == case["port_mismatch"] and d <= 1,
                  f"resize {case['method']} {case['in']} -> {case['out']}: "
                  f"{n} values differ from cv2 (max {d}), "
                  f"{case['port_mismatch']} recorded")
            counts.append((case["in"], case["out"], n))
        else:
            check(_sha(got) == case["sha256"],
                  f"resize {case['method']} {case['in']} -> {case['out']} "
                  f"{case['kind']}: differs from cv2.resize")
    print(f"[preprocess] {card}: resize_u8 on the card: {len(manifest['resize'])}"
          f" cases; equal to cv2.resize on all but the x3 INTER_CUBIC ones, "
          f"which differ where recorded (in, out, values): {counts}")
    return {"encode_ms": enc_ms, "decode_ms": decode_ms,
            "mpeg4": check_mpeg4_fixtures(p, card),
            "webm": check_webm_fixtures(p, card)}


def _mcu_cover(diff: np.ndarray) -> np.ndarray:
    """The pixels that a change of the True values of ``diff`` (h, w) can
    move through a JPEG round trip: their 16x16 MCUs, and one pixel around
    them (the decoder's triangle upsampling reads the next chroma
    sample)."""
    h, w = diff.shape
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    d = np.zeros((ph, pw), bool)
    d[:h, :w] = diff
    m = d.reshape(ph // 16, 16, pw // 16, 16).any(axis=(1, 3))
    m = np.pad(np.repeat(np.repeat(m, 16, 0), 16, 1)[:h, :w], 1)
    grown = m.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grown[1:-1, 1:-1] |= m[1 + dy: h + 1 + dy, 1 + dx: w + 1 + dx]
    return grown[1:-1, 1:-1]


def card_against_cpu(p: PreprocessSlice, dev, card: str) -> dict:
    """Frames of the clip cropped, resized and degraded on the card and on
    the CPU with the same draws (JAX's, made on the CPU, moved to the card):
    the crops equal, the degradation core within 1e-5, then the JPEG round
    trip equal where the uint8 image fed to the encoder is (else confined
    to the 16x16 blocks that hold a value that rounded apart, which is
    counted); the extractor's PNGs from both devices: HR equal, LR equal
    but where (or, after the JPEG stage, inside the blocks where) the core's
    outputs rounded apart."""
    import dataclasses
    import shutil
    import tempfile

    from tpusr_torch.core import prng
    from tpusr_torch.data import _cv_ops as cv
    from tpusr_torch.data import avi, degrade, video as tv
    from tpusr_torch.data.degrade import (degrade_image_core, jpeg_roundtrip,
                                          sample_draws)
    from tpusr_torch.pipeline.png import decode_png_u8

    clip = avi.read_avi(os.path.join(VIDEO_FIXTURES, p.clip))
    frames = [clip.frame(i) for i in p.cpu_frames]
    worst, apart, spread = 0.0, 0, 0
    key = prng.PRNGKey(p.seed)
    for i, frame in zip(p.cpu_frames, frames):
        crops = [cv.resize_u8(tv.smart_square_crop(torch.from_numpy(
            frame).to(d)), (p.hr_size, p.hr_size), "area").cpu()
            for d in (dev, torch.device("cpu"))]
        check(torch.equal(*crops),
              f"frame {i}: the crop + resize differs between card and CPU")
        hr = crops[1].flip(-1).float() / 255.0
        key, sub = prng.split(key)
        draws = dataclasses.replace(sample_draws(sub, tuple(hr.shape)),
                                    jpeg=True)
        lr_dev, _ = degrade_image_core(hr.to(dev), draws)
        lr_cpu, _ = degrade_image_core(hr, draws)
        err = float((lr_dev.cpu() - lr_cpu).abs().max())
        check(err <= 1e-5, f"frame {i}: the degradation core on the card "
                           f"differs from the CPU's by {err} > 1e-5")
        worst = max(worst, err)
        u8 = [np.clip(t.cpu().numpy() * 255.0, 0, 255).round() for t in
              (lr_dev, lr_cpu)]
        diff = (u8[0] != u8[1]).any(-1)
        apart += int(diff.sum())
        out = [jpeg_roundtrip(t, draws.jpeg_quality).cpu().numpy()
               for t in (lr_dev, lr_cpu)]
        moved = (out[0] != out[1]).any(-1)
        check(not (moved & ~_mcu_cover(diff)).any(),
              f"frame {i}: the JPEG round trip differs outside the blocks "
              f"whose encoder input rounded apart")
        spread += int(moved.sum())
    work = tempfile.mkdtemp(prefix="chip_smoke_preprocess_")
    cores = {"cuda": [], "cpu": []}

    def keep(d):
        def wrap(orig):
            def run(hr01, draws, *a, **kw):
                lr, idx = orig(hr01, draws, *a, **kw)
                cores[d].append((lr.cpu().numpy(), draws.jpeg))
                return lr, idx
            return run
        return wrap

    try:
        for d in ("cuda", "cpu"):
            with patched(degrade, degrade_image_core=keep(d)):
                tv.create_hr_lr_images_from_frames(
                    frames, 1.0, os.path.join(work, d, "HR"),
                    os.path.join(work, d, "LR"), hr_size=p.hr_size,
                    device=dev if d == "cuda" else "cpu",
                    key=p.seed + 1)
        png_apart = 0
        names = sorted(os.listdir(os.path.join(work, "cpu", "HR")))
        for name, (a_core, jpeg), (b_core, _) in zip(names, cores["cuda"],
                                                     cores["cpu"]):
            a, b = (decode_png_u8(open(os.path.join(work, d, "HR", name),
                                       "rb").read()) for d in ("cuda", "cpu"))
            check(np.array_equal(a, b), f"{name}: the HR PNG differs between "
                                        f"card and CPU")
            a, b = (decode_png_u8(open(os.path.join(work, d, "LR", name),
                                       "rb").read()) for d in ("cuda", "cpu"))
            rounded = (np.clip(a_core * 255.0, 0, 255).round()
                       != np.clip(b_core * 255.0, 0, 255).round()).any(-1)
            moved = (a != b).any(-1)
            allowed = _mcu_cover(rounded) if jpeg else rounded
            check(not (moved & ~allowed).any(),
                  f"{name}: the LR PNG differs between card and CPU beyond "
                  f"the values that rounded apart")
            png_apart += int(moved.sum())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[preprocess] {card}: card against CPU on {len(frames)} frames of "
          f"{p.clip} with the same draws: crop + INTER_AREA resize equal; "
          f"the degradation core within {worst:.3g} (<= 1e-5); {apart} LR "
          f"pixels rounded apart at uint8, the JPEG round trip differing at "
          f"{spread} pixels, all inside their 16x16 blocks; the written PNGs: "
          f"HR equal, LR differing at {png_apart} pixels, all where a value "
          f"rounded apart (or inside its blocks after the JPEG stage)")
    return {"core_err": worst, "u8_apart": apart, "png_apart": png_apart}


class preprocess_stage_times:
    """While open, time each stage of ``preprocess`` per call: the frame
    decode (an MJPEG frame, or every MPEG-4 VOP or VP8 frame), the BGR
    conversion of an MPEG-4 or VP8 frame, the crop, the resize, the JPEG
    round trip and the PNG writes on the host clock (each ended by a device
    barrier), the degradation core by CUDA events."""

    STAGES = ("decode", "convert", "crop", "resize", "jpeg", "png")

    def __init__(self, sync):
        self.sync = sync

    def __enter__(self):
        from tpusr_torch.data import (_cv_ops, avi, degrade, mpeg4, video,
                                      vp8video)
        self.ms = {k: [] for k in self.STAGES}
        self.events = []

        def host(key):
            def wrap(orig):
                def run(*a, **kw):
                    t0 = time.perf_counter()
                    out = orig(*a, **kw)
                    self.sync()
                    self.ms[key].append((time.perf_counter() - t0) * 1e3)
                    return out
                return run
            return wrap

        def device(orig):
            def run(*a, **kw):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = orig(*a, **kw)
                ev[1].record()
                self.events.append(ev)
                return out
            return run

        self._p = [patched(avi, decode_mjpeg_frame=host("decode")),
                   patched(mpeg4.Mpeg4Decoder, decode=host("decode")),
                   patched(mpeg4, to_bgr=host("convert")),
                   patched(vp8video.Vp8Decoder, decode=host("decode")),
                   patched(vp8video, to_bgr=host("convert")),
                   patched(video, smart_square_crop=host("crop"),
                           encode_png_u8=host("png")),
                   patched(_cv_ops, resize_u8=host("resize")),
                   patched(degrade, degrade_image_core=device,
                           jpeg_roundtrip=host("jpeg"))]
        for q in self._p:
            q.__enter__()
        return self

    def total(self, key: str) -> float:
        return sum(self.ms[key])

    def per_frame(self, frames: int) -> dict:
        self.sync()
        out = {k: sum(v) / frames for k, v in self.ms.items()}
        out["degrade_device"] = sum(a.elapsed_time(b)
                                    for a, b in self.events) / frames
        return out

    def __exit__(self, *exc):
        for q in self._p[::-1]:
            q.__exit__(*exc)


def preprocess_held_clip(p: PreprocessSlice, path: str, kept: dict,
                         root: str, seed: int, sync, card: str,
                         avi_wall: float) -> dict:
    """``python -m tpusr_torch.cli preprocess --hr-size`` in process on a
    print clip whose frames ``kept`` (index -> BGR) were held to cv2's by
    sha256, with its stages timed: K5's launches alone (one a pair, its
    degradation's noise), one pair a second,
    every frame decoded and only the sampled ones converted, each HR PNG
    equal to the host's ``smart_square_crop`` + ``resize_u8`` of its
    frame. Returns the wall time and the decode and conversion ms."""
    from tpusr_torch.cli.__main__ import main as cli_main
    from tpusr_torch.data import _cv_ops as cv
    from tpusr_torch.data.video import open_video, smart_square_crop
    from tpusr_torch.pipeline.png import decode_png_u8

    name = os.path.basename(path)
    video = open_video(path)
    samples = video.samples
    with preprocess_stage_times(sync) as st:
        reset_counts()
        t0 = time.perf_counter()
        cli_main(["preprocess", "--video", path, "--hr-dir",
                  os.path.join(root, "HR"), "--lr-dir",
                  os.path.join(root, "LR"), "--hr-size", str(p.hr_size),
                  "--seed", str(seed), "--device", "cuda"])
        sync()
        wall = time.perf_counter() - t0
        got = read_counts()
    # one K5 launch a pair: its degradation's noise
    check(got == launches_want(prng=len(kept)),
          f"preprocess on {name}: launched kernels {got}")
    K5_BY_PATH["preprocess"] = K5_BY_PATH.get("preprocess", 0) + got["prng"]
    names = sorted(os.listdir(os.path.join(root, "HR")))
    check(names == [f"sample_{i:05d}.png" for i in range(len(kept))]
          and len(st.ms["decode"]) == len(samples)
          and len(st.ms["convert"]) == len(kept),
          f"preprocess on {name}: wrote {names}, decoded "
          f"{len(st.ms['decode'])} of {len(samples)} frames, converted "
          f"{len(st.ms['convert'])}")
    for png, i in zip(names, sorted(kept)):
        hr = decode_png_u8(open(os.path.join(root, "HR", png), "rb").read())
        want = cv.resize_u8(smart_square_crop(torch.from_numpy(kept[i])),
                            (p.hr_size, p.hr_size), "area").numpy()
        check(np.array_equal(hr, want[..., ::-1]),
              f"preprocess on {name} {png}: the HR PNG differs from the "
              f"host's crop + resize of frame {i}")
    decode, convert = st.total("decode"), st.total("convert")
    run = {"wall_s": wall, "pairs": len(names), "decode_ms": decode,
           "convert_ms": convert}
    kinds = ""
    if name.endswith(".webm"):              # VP8: key frames and the rest
        key = [ms for ms, s in zip(st.ms["decode"], samples) if not s[0] & 1]
        inter = [ms for ms, s in zip(st.ms["decode"], samples) if s[0] & 1]
        run.update(key_ms=float(np.mean(key)), inter_ms=float(np.mean(inter)))
        kinds = (f" ({len(key)} key frames {run['key_ms']:.1f} ms each, "
                 f"{len(inter)} interframes {run['inter_ms']:.1f} ms each)")
    print(f"[preprocess] {card}: preprocess --hr-size {p.hr_size} --device "
          f"cuda on {name} ({getattr(video, 'fourcc', '')}, 1280x720, "
          f"{len(samples)} frames at {video.fps:g} fps): {len(names)} pairs "
          f"in {wall:.2f} s (the MJPEG AVI: {avi_wall:.2f} s); decoding all "
          f"{len(samples)} frames {decode:.0f} ms{kinds} and converting the "
          f"{len(names)} sampled frames {convert:.0f} ms (host), "
          f"{100 * (decode + convert) / 1e3 / wall:.0f}% of the wall; each HR "
          f"PNG equal to the host's smart_square_crop + resize_u8 of the "
          f"sha256-held frame")
    return run


def edsr_x2_train_layers(n: int, h: int, blocks: int, f: int) -> list:
    """(conv, forward shape, relu) of every conv of an x2 EDSR's training
    forward, in order (``edsr_train_layers`` at x2: one upsample conv)."""
    out = [("head", (n, h, h, 3, f), False)]
    for i in range(blocks):
        out += [(f"res{i}.conv1", (n, h, h, f, f), True),
                (f"res{i}.conv2", (n, h, h, f, f), False)]
    return out + [("body", (n, h, h, f, f), False),
                  ("up0", (n, h, h, f, 4 * f), False),
                  ("tail", (n, 2 * h, 2 * h, f, 3), False)]


def phase_preprocess(p: PreprocessSlice, dev, seed: int, sync,
                     card: str) -> dict:
    """The ``preprocess`` command on the card: the committed fixtures (the
    encoder's bytes, the reader's frames, ``resize_u8``), the card against
    the CPU on the same draws, then ``python -m tpusr_torch.cli
    preprocess`` (in process) on the 720p clip with ``--hr-size`` and
    without and on the odd clip, each stage timed per frame, the same
    print as ``.mp4``, ``.webm`` and ``.mkv`` (``preprocess_held_clip``),
    then ``train-edsr --scale 2`` on the pairs it wrote with its first step
    held against K2's twin. The training run is driven with the launch counts
    set to 0 just before it and read just after. Returns its launches."""
    import pickle
    import shutil
    import tempfile

    from tpusr_torch.cli.__main__ import main as cli_main
    from tpusr_torch.config import EDSRConfig
    from tpusr_torch.pipeline.png import decode_png_u8

    t_phase = time.perf_counter()
    fixtures = check_video_fixtures(p, dev, sync, card)
    parity = card_against_cpu(p, dev, card)
    work = tempfile.mkdtemp(prefix="chip_smoke_preprocess_")
    interp_names = {"INTER_LINEAR", "INTER_CUBIC", "INTER_AREA",
                    "INTER_LANCZOS4"}
    clip = os.path.join(VIDEO_FIXTURES, p.clip)
    runs = {}
    try:
        for tag, extra, side in ((f"hr{p.hr_size}", ["--hr-size",
                                                     str(p.hr_size)],
                                  p.hr_size),
                                 ("crop", [], 720)):
            root = os.path.join(work, tag)
            argv = ["preprocess", "--video", clip, "--hr-dir",
                    os.path.join(root, "HR"), "--lr-dir",
                    os.path.join(root, "LR"), "--interp-map",
                    os.path.join(root, "interp_map.pkl"), "--class-map",
                    os.path.join(root, "class_map.pkl"), "--class-id", "1",
                    "--seed", str(seed), *extra, "--device", "cuda"]
            with preprocess_stage_times(sync) as st:
                reset_counts()
                t0 = time.perf_counter()
                cli_main(argv)
                sync()
                wall = time.perf_counter() - t0
                got = read_counts()
            # one K5 launch for each of the 4 pairs: its degradation's noise
            check(got == launches_want(prng=4),
                  f"preprocess {tag}: launched kernels {got}")
            K5_BY_PATH["preprocess"] = (K5_BY_PATH.get("preprocess", 0)
                                        + got["prng"])
            names = sorted(os.listdir(os.path.join(root, "HR")))
            check(names == [f"sample_{i:05d}.png" for i in range(4)]
                  and sorted(os.listdir(os.path.join(root, "LR"))) == names,
                  f"preprocess {tag}: wrote {names}")
            for name in names:
                hr = decode_png_u8(open(os.path.join(root, "HR", name),
                                        "rb").read())
                lr = decode_png_u8(open(os.path.join(root, "LR", name),
                                        "rb").read())
                check(hr.shape == (side, side, 3)
                      and lr.shape == (side // 2, side // 2, 3),
                      f"preprocess {tag} {name}: HR {hr.shape} LR {lr.shape}")
            imap = pickle.load(open(os.path.join(root, "interp_map.pkl"), "rb"))
            cmap = pickle.load(open(os.path.join(root, "class_map.pkl"), "rb"))
            check(sorted(imap) == names and set(imap.values()) <= interp_names
                  and cmap == {n: 1 for n in names},
                  f"preprocess {tag}: maps {imap} {cmap}")
            ms = st.per_frame(len(names))
            runs[tag] = {"wall_s": wall, "pairs": len(names), **ms}
            print(f"[preprocess] {card}: preprocess {' '.join(extra) or '(no '
                  f'--hr-size)'} --device cuda on {p.clip} (1280x720, 40 "
                  f"frames at 10 fps): {len(names)} pairs of {side}^2 / "
                  f"{side // 2}^2 in {wall:.2f} s; per frame: read + decode "
                  f"{ms['decode']:.1f} ms, crop {ms['crop']:.1f} ms, resize "
                  f"{ms['resize']:.1f} ms, degrade {ms['degrade_device']:.2f}"
                  f" ms (device, CUDA events), JPEG round trip "
                  f"{ms['jpeg']:.1f} ms, PNG write {ms['png']:.1f} ms "
                  f"(host); interps {sorted(set(imap.values()))}")
        root = os.path.join(work, "odd")
        cli_main(["preprocess", "--video", os.path.join(VIDEO_FIXTURES,
                                                        p.odd_clip),
                  "--hr-dir", os.path.join(root, "HR"), "--lr-dir",
                  os.path.join(root, "LR"), "--predictions", "--class-map",
                  os.path.join(root, "p.pkl"), "--class-id", "2",
                  "--device", "cuda"])
        names = sorted(os.listdir(os.path.join(root, "HR")))
        hr = decode_png_u8(open(os.path.join(root, "HR", names[0]), "rb").read())
        check(len(names) == 2 and hr.shape == (58, 58, 3)
              and pickle.load(open(os.path.join(root, "p.pkl"), "rb"))
              == {n: 2 for n in names},
              f"preprocess --predictions on {p.odd_clip}: {names} {hr.shape}")
        print(f"[preprocess] {card}: preprocess --predictions on "
              f"{p.odd_clip}: {len(names)} pairs, the 59^2 crop trimmed to "
              f"58^2, the predictions class map written")

        # the same print as MPEG-4 Part 2 in MP4, VP8 in WebM and MPEG-4
        # Part 2 in Matroska: each HR PNG against the host's crop + resize
        # of the sha256-held frame it came from
        for tag, folder, name, kept in (
                ("mp4", MPEG4_FIXTURES, p.mp4_clip,
                 fixtures["mpeg4"].pop("kept")),
                ("webm", WEBM_FIXTURES, p.webm_clip,
                 fixtures["webm"]["kept"].pop(p.webm_clip)),
                ("mkv", WEBM_FIXTURES, p.mkv_clip,
                 fixtures["webm"].pop("kept").pop(p.mkv_clip))):
            runs[tag] = preprocess_held_clip(
                p, os.path.join(folder, name), kept, os.path.join(work, tag),
                seed, sync, card, runs[f"hr{p.hr_size}"]["wall_s"])

        # train-edsr --scale 2 on the 512^2 pairs the command wrote
        ed = EDSRConfig()
        data = os.path.join(work, f"hr{p.hr_size}")
        argv = ["train-edsr", "--hr-dir", os.path.join(data, "HR"),
                "--lr-dir", os.path.join(data, "LR"), "--scale", "2",
                "--epochs", str(p.edsr_epochs), "--out",
                os.path.join(work, "ck"), "--device", "cuda"]
        with (count_plain_calls() as plain, split_sizes() as sp,
              first_train_step() as first):
            reset_counts()
            t0 = time.perf_counter()
            path = cli_main(argv)
            sync()
            wall = time.perf_counter() - t0
            got = read_counts()
        check(plain.n == 0, f"train-edsr: plain twins on the card "
                            f"{plain.by_twin}")
        (sizes,) = sp.sizes
        per_step = (2 * (2 * ed.num_res_blocks + 4) - 1,
                    2 * ed.num_res_blocks + 4)
        want_k2 = k2_command_launches(sizes, 16, p.edsr_epochs, *per_step,
                                      False)
        built = leaves_of("EDSR", scale_factor=2,
                          num_res_blocks=ed.num_res_blocks,
                          num_filters=ed.num_filters)    # its model, drawn
        check(got == launches_want(conv3x3_bias_act=want_k2, prng=built),
              f"train-edsr on the preprocess pairs: launches {got}, expected "
              f"{want_k2} K2, {built} K5 (its model's build) and no other")
        meta = json.load(open(path + ".meta.json"))
        ev = meta["eval"]
        check(math.isfinite(ev["loss"]) and math.isfinite(ev["psnr"]),
              f"train-edsr on the preprocess pairs: eval {ev}")
        tr, w, x, y = first.got
        n, lr_side = x.shape[0], x.shape[1]
        par = w["params"]
        line = command_step_against_twin(
            "train-edsr x2", edsr_x2_train_layers(n, lr_side,
                                                  ed.num_res_blocks,
                                                  ed.num_filters), par,
            lambda: tr._apply(par, x),
            lambda: tr._loss(par, x, y, tr._ones_weights(n), 0)[0])
        del first.got, tr, w, x, y, par
        print(f"[preprocess] {card}: train-edsr --scale 2 on the "
              f"{p.hr_size}^2 pairs: split {sizes[0]}/{sizes[1]}/{sizes[2]} "
              f"patches, {p.edsr_epochs} epoch in {wall:.1f} s, eval loss "
              f"{ev['loss']:.5f}, PSNR {ev['psnr']:.2f} dB; K2 "
              f"{got['conv3x3_bias_act']} launches ({per_step[0]} a train "
              f"step, {per_step[1]} an eval step); {line}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ms = (time.perf_counter() - t_phase) * 1e3
    print(f"[preprocess] {card}: phase_preprocess {ms:.0f} ms")
    return {"launches": got, "runs": runs, "fixtures": fixtures,
            "parity": parity, "ms": ms}


# ----------------------------------------------------------------- formats

FORMAT_FIXTURES = os.path.join(REPO, "tests", "data", "formats")
# (the [formats] line's name, the 512^2 fixture timed)
FORMAT_TIMED = (("baseline JPEG", "s512_baseline.jpg"),
                ("progressive JPEG", "s512_progressive.jpg"),
                ("PNG", "s512.png"), ("Adam7 PNG", "s512_adam7.png"),
                ("BMP", "s512.bmp.xz"), ("TIFF none", "s512_none.tif.xz"),
                ("TIFF LZW", "s512_lzw.tif"),
                ("TIFF Deflate", "s512_deflate.tif"))
# the committed 128^2 LR bodies phase_serve sends, by format
SERVE_FORMATS = {"progressive JPEG": "_progressive.jpg",
                 "Adam7 PNG": "_adam7.png", "BMP": ".bmp.xz", "TIFF": ".tif",
                 "WebP lossy": "_lossy.webp", "WebP lossless": "_lossless.webp",
                 "GIF": ".gif"}
SERVE_FORMAT_REPEATS = 2     # each fixture sent twice: 8 bodies a format
# committed LR bodies sent once to /classify beside their PNG twins
SERVE_ONCE = {"PPM": "lr0.ppm.xz", "HDR": "lr0.hdr"}
# the formats only the HTTP tier reads, timed at 128^2 and 512^2: the
# committed WebP and GIF fixtures; the others written from lr0's and
# s512's pixels by tests/torch_image_writers.py (``served_format_bodies``)
SERVED_TIMED = {"WebP lossy": ("lr0_lossy.webp", "s512_lossy.webp"),
                "WebP lossless": ("lr0_lossless.webp", "s512_lossless.webp"),
                "GIF": ("lr0.gif", "s512.gif")}


def served_format_bodies() -> dict:
    """{format: {side: (body, the pixels its decode must equal or
    None)}} at sides 128 and 512: the committed WebP and GIF fixtures
    (held by the manifest's sha256), and PPM, PAM, Sun raster, HDR and PFM
    bodies written by hand from the RGB of ``lr0_adam7.png`` and
    ``s512.png``, each decoding to a known image: the pixels (PPM, Sun
    raster, PFM), their channels reversed (PAM ``RGB``, which OpenCV reads
    as B, G, R), or the pixels clipped to 254 through RGBE mantissas chosen
    to round back to them (HDR)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_image_writers import (sunras_rows, write_hdr, write_pfm,
                                     write_sunras)

    from tpusr_torch.pipeline.png import decode_png_u8
    out = {label: {side: (format_fixture(name), None)
                   for side, name in zip((128, 512), names)}
           for label, names in SERVED_TIMED.items()}
    for side, name in ((128, "lr0_adam7.png"), (512, "s512.png")):
        rgb = decode_png_u8(format_fixture(name))
        h, w, _ = rgb.shape
        # RGBE at exponent 128 (a factor 2^-8): mantissa q for q < 128, q + 1
        # above, rounds back to q after x255 (255 itself cannot: clipped)
        q = np.minimum(rgb, 254).astype(np.int64)
        rgbe = np.concatenate([np.where(q < 128, q, q + 1),
                               np.full((h, w, 1), 128)], -1).astype(np.uint8)
        want_hdr = q.astype(np.uint8)
        bodies = {
            "PPM": (b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes(), rgb),
            "PAM": (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\n"
                    b"TUPLTYPE RGB\nENDHDR\n" % (w, h) + rgb.tobytes(),
                    rgb[..., ::-1]),
            "Sun raster": (write_sunras(w, h, 24, sunras_rows(
                rgb[..., ::-1], 24)), rgb),
            "HDR": (write_hdr(rgbe), want_hdr),
            "PFM": (write_pfm(rgb.astype(np.float32)), rgb)}
        for label, pair in bodies.items():
            out.setdefault(label, {})[side] = pair
    return out


@dataclass(frozen=True)
class FormatsSlice:
    """The image formats the port decodes beside PNG: the committed
    fixtures (``tests/data/formats``) against cv2's decode in their
    manifest, a 512^2 decode per format timed, and ``classic`` on ``.tiff``
    and ``.bmp`` twins of ``images`` HR/LR PNG pairs made as
    ``phase_commands`` makes its surfaces."""
    images: int = 4              # pairs, and classic's --limit


def format_fixture(name: str) -> bytes:
    """A fixture's bytes as the decoders read them (``.xz`` ones
    unpacked)."""
    import lzma
    with open(os.path.join(FORMAT_FIXTURES, name), "rb") as f:
        stored = f.read()
    return lzma.decompress(stored) if name.endswith(".xz") else stored


def write_format_twins(src: str, dst: str) -> None:
    """Each PNG under ``src``/HR and ``src``/LR rewritten as a TIFF
    (Deflate, predictor 2) under ``{dst}_tiff`` and as a 24 bpp BMP under
    ``{dst}_bmp``, by ``tests/torch_image_writers.py``."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_image_writers import bmp_rows, write_bmp, write_tiff

    from tpusr_torch.pipeline.png import decode_png_u8
    for sub in ("HR", "LR"):
        for fmt in ("tiff", "bmp"):
            os.makedirs(os.path.join(f"{dst}_{fmt}", sub))
        for name in sorted(os.listdir(os.path.join(src, sub))):
            with open(os.path.join(src, sub, name), "rb") as f:
                rgb = decode_png_u8(f.read())
            stem = name.rsplit(".", 1)[0]
            h, w, _ = rgb.shape
            for fmt, body in (
                    ("tiff", write_tiff(rgb, compression=8, predictor=2,
                                        rows_per_strip=16)),
                    ("bmp", write_bmp(w, h, 24, bmp_rows(
                        rgb[::-1, :, ::-1].reshape(h, -1), 8)))):
                with open(os.path.join(f"{dst}_{fmt}", sub, f"{stem}.{fmt}"),
                          "wb") as f:
                    f.write(body)


def phase_formats(f: FormatsSlice, dev, seed: int, sync, card: str) -> dict:
    """Host work and one command on the card: every committed format
    fixture decoded and held against the sha256 of cv2's decode in
    ``manifest.json``; the decode of one 512^2 image in each format timed
    (host clock, best of 3); then ``classic --limit {images} --device
    cuda`` in process on PNG pairs and on their ``.tiff`` and ``.bmp``
    twins, each run driven with the launch counts set to 0 just before it
    and read just after: the JSON (times and memory aside) and K4's
    launches of the twins equal the PNG run's. Returns K4's launches."""
    import hashlib
    import shutil
    import tempfile

    from tpusr_torch.cli.__main__ import main as cli_main
    from tpusr_torch.core import nlm
    from tpusr_torch.pipeline.imdecode import decode_image_u8, image_format

    t_phase = time.perf_counter()
    with open(os.path.join(FORMAT_FIXTURES, "manifest.json")) as fh:
        manifest = json.load(fh)
    for name, want in sorted(manifest.items()):
        with open(os.path.join(FORMAT_FIXTURES, name), "rb") as fh:
            check(hashlib.sha256(fh.read()).hexdigest() == want["file_sha256"],
                  f"format fixture {name}: not the file its manifest names")
        got = decode_image_u8(format_fixture(name))
        check(list(got.shape) == want["shape"] and hashlib.sha256(
            got.tobytes()).hexdigest() == want["sha256"],
            f"format fixture {name}: the decode differs from cv2's")
    kinds = sorted({image_format(format_fixture(n)) for n in manifest})
    print(f"[formats] {len(manifest)} fixtures ({', '.join(kinds)}) decode "
          f"to cv2's bytes (the sha256 in tests/data/formats/manifest.json)")
    served = {}
    for label, sides in served_format_bodies().items():
        for side, (body, want) in sides.items():
            got = decode_image_u8(body)
            if want is not None:
                check(np.array_equal(got, want), f"{label} {side}^2: the "
                      f"decode differs from the pixels it was written from")
            check(got.shape == (side, side, 3), f"{label} {side}^2: shape "
                                                f"{got.shape}")
            ms = min(host_ms(lambda: decode_image_u8(body), sync)
                     for _ in range(2))
            served.setdefault(label, {})[side] = {"ms": ms,
                                                  "bytes": len(body)}
        held = "committed, held by the manifest" if label in SERVED_TIMED \
            else "written here, equal to their pixels"
        print(f"[formats] {card}: {label} decode " + ", ".join(
            f"{side}^2 {v['ms']:.1f} ms ({v['bytes']} bytes)"
            for side, v in served[label].items()) + f" (host clock, best of "
            f"2; {held})")
    timed = {}
    for label, name in FORMAT_TIMED:
        body = format_fixture(name)
        ms = min(host_ms(lambda: decode_image_u8(body), sync)
                 for _ in range(3))
        timed[label] = {"ms": ms, "bytes": len(body)}
        print(f"[formats] {card}: {label} 512^2 decode {ms:.1f} ms (host "
              f"clock, best of 3), {len(body)} bytes")
    work = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    runs, k4 = {}, {}
    try:
        c = CommandsSlice(images=f.images)
        png_dir = os.path.join(work, "png")
        write_reference_dataset(png_dir, c, seed + c.train_seed, dev,
                                maps=True)
        write_format_twins(png_dir, os.path.join(work, "twin"))
        for fmt, root in (("png", png_dir),
                          ("tiff", os.path.join(work, "twin_tiff")),
                          ("bmp", os.path.join(work, "twin_bmp"))):
            out = os.path.join(work, f"out_{fmt}")
            argv = ["classic", "--hr-dir", os.path.join(root, "HR"),
                    "--lr-dir", os.path.join(root, "LR"), "--fraction", "1.0",
                    "--limit", str(f.images), "--out", out]
            with count_plain_calls() as plain:
                reset_counts()
                nlm.reset_launch_counts()
                t0 = time.perf_counter()
                cli_main(argv)
                sync()
                wall = time.perf_counter() - t0
                got = read_counts()
                k4[fmt] = nlm.LAUNCHES["nlm_denoise"]
            check(plain.n == 0, f"classic on {fmt}: plain twins on the card "
                                f"{plain.by_twin}")
            check(not any(got.values()), f"classic on {fmt}: launches {got} "
                                         f"of kernels classic does not run")
            res = json.load(open(os.path.join(out, "classic_summary.json")))
            runs[fmt] = {alg: {k: v for k, v in row.items()
                               if not k.startswith(("time_", "memory_"))}
                         for alg, row in res["summary"].items()}
            print(f"[formats] {card}: classic --limit {f.images} --device "
                  f"cuda on {f.images} {fmt.upper()} pairs ({c.size}^2 / "
                  f"{c.size // 4}^2) in {wall:.1f} s; K4 {k4[fmt]} launches")
        for fmt in ("tiff", "bmp"):
            check(runs[fmt] == runs["png"], f"classic on {fmt}: the JSON "
                                            f"differs from the PNG run's")
            check(k4[fmt] == k4["png"] == f.images * 3 + 1,
                  f"classic on {fmt}: K4 launches {k4[fmt]}, PNG run "
                  f"{k4['png']}, expected {f.images * 3 + 1}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ms = (time.perf_counter() - t_phase) * 1e3
    print(f"[formats] {card}: classic's JSON (times and memory aside) and K4 "
          f"launches on the .tiff and .bmp twins equal the PNG run's; "
          f"phase_formats {ms:.0f} ms")
    return {"launches": {"nlm_denoise": sum(k4.values())}, "decode": timed,
            "served_decode": served, "ms": ms}


def kernel_record(name, source, replaces, launches, tot, library) -> dict:
    rec = {"name": name, "route": "cuda",
           "source": f"tpusr_torch/csrc/{source}", "replaces": replaces,
           "launches": launches, "max_abs_err": tot["err"],
           "ms": tot["ms"], "plain_ms": tot["plain_ms"],
           "bound_ms": tot["bound_ms"],
           "bound_by": "operations" if tot["t_ops"] >= tot["t_bytes"] else "bytes",
           "library_ms": library}
    if "gemm_library_ms" in tot:     # torch._int_mm, the GEMM alone
        rec["gemm_library_ms"] = tot["gemm_library_ms"]
    for key in ("k1_path_ms", "instruction",    # K3: the path it replaced
                "kernel_ms"):                   # K4: the bare launch
        if key in tot:
            rec[key] = tot[key]
    return rec


def train_record(tot) -> dict:
    """K2 on the training path: one EDSR x4 train step's 37 forward and 36
    dX launches (``ms`` = ``fwd_ms`` + ``dx_ms``); ``launches`` counts the
    main training path."""
    return {"launches": tot["launches"], "max_abs_err": tot["err"],
            "ms": tot["ms"], "fwd_ms": tot["fwd_ms"], "dx_ms": tot["dx_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["t_ops"] >= tot["t_bytes"]
                         else "bytes"),
            "library_ms": tot["library_ms"]}


def inference_record(tot) -> dict:
    """K2 on one SR path of ``phase_inference``: the sums over its launches
    of K2's, the twin's, ``F.conv2d``'s and the bound's ms at each shape."""
    return {"max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["t_ops"] >= tot["t_bytes"]
                         else "bytes"),
            "library_ms": tot["library_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-cards", type=int, default=0,
                    help="run only the parallelism layer over N cards, one "
                         "NCCL rank each (phase_dist_cards)")
    ap.add_argument("--init-probe", choices=("card", "cpu"),
                    help=argparse.SUPPRESS)    # phase_init's fresh process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import tpusr_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = Slice()
    if args.init_probe:
        print(json.dumps(init_probe(args.init_probe, args.seed, dev)))
        return 0
    if args.dist_cards:
        try:
            card = phase_environment()
            phase_build()
            phase_dist_cards(args.dist_cards, args.seed, card)
        except CheckFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    try:
        card = phase_environment()
        phase_build()
        k5 = phase_prng(PrngSlice(), dev, card)
        watch_model_builds()
        init = phase_init(InitSlice(), dev, args.seed, card)
        k1 = phase_k1(cfg, dev)
        k3 = phase_k3(cfg, dev)
        k2 = phase_k2(cfg, dev, torch.float32)
        k2b = phase_k2(cfg, dev, torch.bfloat16)
        k4 = phase_k4(dev)
        sync = torch.cuda.synchronize
        launches, state = in_path("slice", phase_slice, cfg, dev, args.seed,
                                  sync, card)
        bf16_launches = phase_bf16(cfg, dev, state, sync, card)
        dequant_launches, dq = phase_int8_sr(cfg, dev, state, sync, card)
        in_path("f32_modes", phase_f32_modes, cfg, dev, state, sync, card)
        del state
        torch.cuda.empty_cache()
        k4_launches = phase_classic(dev, args.seed, sync, card)
        torch.cuda.empty_cache()
        inference = in_path("inference", phase_inference, InferenceSlice(),
                            dev, args.seed, sync, card)
        torch.cuda.empty_cache()
        train = in_path("train", phase_train, TrainSlice(), dev, args.seed,
                        sync, card)
        torch.cuda.empty_cache()
        gan = in_path("gan", phase_gan, GanSlice(), dev, args.seed, sync,
                      card)
        torch.cuda.empty_cache()
        gate, trained = in_path("gate", phase_gate, GateSlice(), cfg, dev,
                                args.seed, sync, card)
        serve = in_path("serve", phase_serve, GateSlice(), cfg, dev,
                        args.seed, sync, card, trained)
        torch.cuda.empty_cache()
        dist_res = in_path("dist", phase_dist, DistSlice(), cfg, dev,
                           args.seed, sync, card, trained,
                           train["edsr_step_ms"])
        del trained
        torch.cuda.empty_cache()
        commands = in_path("commands", phase_commands, CommandsSlice(), dev,
                           args.seed, sync, card)
        torch.cuda.empty_cache()
        eda = phase_eda(EdaSlice(), dev, args.seed, sync, card)
        poly = in_path("poly", phase_poly, PolySlice(), dev, args.seed, sync,
                       card)
        phase_winograd(WinogradSlice(), dev, args.seed, card)
        torch.cuda.empty_cache()
        h5 = in_path("h5", phase_h5, H5Slice(), cfg, dev, args.seed, sync,
                     card)
        torch.cuda.empty_cache()
        orbax_res = in_path("orbax", phase_orbax, OrbaxSlice(), cfg, dev,
                            args.seed, sync, card)
        torch.cuda.empty_cache()
        pre = in_path("preprocess", phase_preprocess, PreprocessSlice(), dev,
                      args.seed, sync, card)
        torch.cuda.empty_cache()
        fmts = phase_formats(FormatsSlice(), dev, args.seed, sync, card)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    k2_rec = kernel_record("conv3x3_bias_act", "conv3x3_bias_act.cu",
                           "tpusr/core/pallas_conv.py:123",
                           launches["conv3x3_bias_act"], k2, k2["library_ms"])
    k2_rec["train"] = train_record(train)
    k2_rec["gan"] = {**train_record(gan["k2"]),
                     "step_ms": gan["k2"]["step_ms"],
                     "wide_g32x23": {k: gan["k2"]["wide"][k] for k in (
                         "ms", "fwd_ms", "dx_ms", "plain_ms", "bound_ms",
                         "library_ms")}}
    records = [
        kernel_record("conv3x3_int8_requant", "conv3x3.cu",
                      "tpusr/core/pallas_conv.py:78",
                      launches["conv3x3_int8_requant"], k1, None),
        k2_rec,
        {**kernel_record("conv3x3_bias_act_bf16", "conv3x3_bias_act.cu",
                         "tpusr/core/pallas_conv.py:123",
                         bf16_launches["conv3x3_bias_act_bf16"], k2b,
                         k2b["library_ms"]),
         "train": {**train_record(gan["k2_bf16"]),
                   "step_ms": gan["k2_bf16"]["step_ms"]}},
        kernel_record("nlm_denoise", "nlm.cu", "tpusr/core/pallas_nlm.py:81",
                      k4_launches, k4, None),
        kernel_record("block1_int8", "block1.cu",
                      "tpusr/models/pallas_vgg.py:275",
                      launches["block1_int8"], k3, None),
        kernel_record("conv3x3_int8_dequant", "conv3x3.cu",
                      "tpusr/models/edsr_quant.py:117", dequant_launches, dq,
                      None),
        # K5: no Pallas kernel; XLA's threefry2x32 and jax.random samplers,
        # at the JAX gate's noise draw. Its times are that draw's (100.7 M
        # normals); ``launches`` is the gate's run
        {**kernel_record("prng", "prng.cu", "tpusr/tools/serving_gate.py:97",
                         gate["prng"], k5, None),
         "randn_ms": k5["randn_ms"], "by_draw": k5["by_draw"],
         "sass_per_value": k5["sass"], "threefry_bound_ms": k5["threefry_ms"],
         # phase_init: each full-width model built on the card against the
         # CPU's draw, and the fresh processes' builds
         "init": {"models": init["rows"],
                  "fresh_card_ms": init["probe"]["all_ms"],
                  "fresh_card_gate_ms": init["probe"]["gate_ms"],
                  "fresh_cpu_gate_ms": init["parent_probe"]["gate_ms"]}},
    ]
    k2_rec["dist"] = {          # phase_dist: K2 at the new shapes
        "dp_step_ms": dist_res["dp_step_ms"],
        "unsharded_step_ms": dist_res["unsharded_step_ms"],
        "train_step_ms": train["edsr_step_ms"], "sp": dist_res["sp"],
        "shapes": dist_res["k2_times"]}
    k2_rec["poly"] = {          # phase_poly: the uncomposed polyphase path
        "launches": poly["launches"]["conv3x3_bias_act"],
        "forward_ms": poly["ms"]["f32"]["ms"],
        "fused_forward_ms": poly["ms"]["f32"]["fused_ms"],
        "bf16_forward_ms": poly["ms"]["bf16"]["ms"],
        "fused_bf16_forward_ms": poly["ms"]["bf16"]["fused_ms"],
        **inference_record(poly["k2"])}
    k2_rec["inference"] = {     # phase_inference, per path
        path: {"launches": n, **inference_record(inference["k2"][path])}
        for path, n in inference["launches"].items() if n}
    for rec in records:     # the serving gate's launches (phase_gate)
        rec["gate_launches"] = gate.get(rec["name"], 0)
        if rec["name"] == "prng":
            rec["launches_by_path"] = {"prng_phase": k5["phase_launches"],
                                       **K5_BY_PATH}
            continue
        # every path that launched the kernel: its name -> its launches
        rec["launches_by_path"] = {
            "slice": rec["launches"], "gate": rec["gate_launches"],
            **{f"serve_concurrency_{c}": n.get(rec["name"], 0)
               for c, n in serve["launches"].items()},
            "serve_formats": serve["format_launches"].get(rec["name"], 0),
            **({f"inference_{p}": n for p, n in
                inference["launches"].items() if n}
               if rec["name"] == "conv3x3_bias_act" else {}),
            **({"train": rec["train"]["launches"], "gan": rec["gan"]["launches"]}
               if rec["name"] == "conv3x3_bias_act" else {}),
            **({"gan": rec["train"]["launches"]}
               if rec["name"] == "conv3x3_bias_act_bf16" else {}),
            **({f"commands_{c.replace('-', '_')}": n[rec["name"]]
                for c, n in commands.items()}
               if rec["name"] in ("conv3x3_bias_act", "nlm_denoise") else {}),
            **{path: n.get(rec["name"], 0)
               for path, n in dist_res["launches"].items()},
            "eda": eda["launches"].get(rec["name"], 0),
            "poly": poly["launches"].get(rec["name"], 0),
            "h5": h5["launches"].get(rec["name"], 0),
            "orbax": orbax_res["launches"].get(rec["name"], 0),
            "preprocess": pre["launches"].get(rec["name"], 0),
            "formats": fmts["launches"].get(rec["name"], 0)}
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
