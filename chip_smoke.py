#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port, on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout

It drives the port's flagging service, its training main path, the
train -> export -> serve loop, the file path (generator -> batch files ->
streamed training), the raw-patch path, the coherent 8-channel path, the
SOLOLite instance path, the measurement-set path and the command-line
entry points (``rfi_toolbox_tpu_torch``) on the card and fails (non-zero
exit) if any phase fails:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: one nvcc per source, all started together, and one link build
   the CUDA kernels into build/torch_kernels/; the compiler's report of
   the conv kernels (registers, spills, shared memory, from nvcc.log's
   ``-Xptxas -v``) and the count of tensor-core TF32 MMAs in the SASS of
   K6a's, K6b's and K7's kernels (``cuobjdump -sass``), which must be the
   three MMAs a product of 3xTF32 for every tile of the kernel's loop
   body; the same report of K1's, K2's and K4's kernel (one template,
   12 instances), its dynamic shared memory and its cluster launch
   (clusters of 4 CTAs that fit on the card, CTAs an SM), for each of
   the three; the same report of the resident-group kernel (K4, K2 and K1
   above 128 x 128, 12 instances: registers, spills, its dynamic shared
   memory and the CTAs resident on an SM and on the card), of the strip
   kernel (above 128 x 128 where the group kernel's slabs do not fit) and
   of K3's kernel (4 instances: TMA or per-thread loads, planes or
   images; registers, spills, shared memory, CTAs resident);
3. K4 (fused_extract_channels) against its plain PyTorch version on the
   card: 512 complex64 128x128 patches cut from 8 waterfalls of 1024 x
   1024, an odd N, a constant patch, real float32 input, NaN pixels (and
   a patch of NaN only), ragged patch sizes (3 x 5, 5 x 7, 33 x 128, 128
   x 127) and input 8 bytes off 16-byte alignment (the last two take
   1-pixel groups): max abs diff <= 2e-5, NaN where the plain version has
   NaN and no inf (``extract_err``); time per call (CUDA events, see
   ``cuda_ms``); then patches above 128 x 128 on the same kinds of input:
   32 and 512 x 256^2 and the 8 whole 1024^2 waterfalls, complex and real,
   NaN pixels and a patch of NaN only, a constant patch, ragged 129 x 130
   and 1000 x 1024, input 8 bytes off 16-byte alignment, and one 2048^2
   patch: the wrapper by the route ``extract_route`` gives the shape, and
   both the resident-group kernel and the two-pass strip kernel launched
   directly, each within 2e-5 of the plain version and all three equal
   element for element; the kernels a call launches (torch.profiler, each
   kernel counted over 8 calls: the group kernel once a call on the group
   route, the strip route's 3 kernels once a call each); both kernels'
   times and bounds at
   (32, 256, 256) (phase 15's step) and (128, 1024, 1024) (phase 14's
   generation batch);
4. K5 (mad_flag_patches) at sigma 5 against its plain version, flags
   bit-equal: the 512 patches, whole 1024 x 1024 waterfalls, patches with
   NaNs, negative real input, and the cases that stress its radix select:
   values quantised to a few levels, constant patches, +-0.0, middle
   pairs that straddle a digit's bins, a ragged patch size; time per
   call;
5. the model path, flag_waterfalls(method="model") with the shipped
   UNet16 snapshots (BatchNorm, GroupNorm) at full width on the 8 x 1024
   x 1024 waterfalls: IoU against the known RFI mask (> 0.9), K4
   launches, waterfalls/s; the card's logits against the same predictor on the CPU
   (TF32 off) on 8 patches; and the BatchNorm snapshot at patch_size=256
   (K4's resident-group kernel), whose masks equal the same predictor's on
   the plain extraction on >= 99.9% of the pixels;
6. the MAD path, flag_waterfalls(method="mad", sigma=5): IoU (> 0.5), K5
   launches, waterfalls/s;
7. K2 (fused_extract_channel_planes), K1 (fused_gather_extract) and K3
   (fused_plane_gather_transform) against their plain versions on the
   512 base patches of 8 generated 1024 x 1024 waterfalls and the
   K=1920 indices of a real static selection (repeats, all four
   variants), plus an odd K, a constant patch, real float32 input (the
   patches' amplitudes), NaN pixels (and a patch of NaN only), ragged
   patch sizes (3 x 5, 5 x 7, 33 x 128, and 128 x 127, whose rows take
   1-pixel groups), and for K1 repeated (base, plane) pairs, base
   patches no output selects and one base patch selected 150 times
   (more than one list of its outputs): K1 and K2 within 2e-5 (NaN where
   the plain version has NaN), shapes equal; K3 bit-equal (0 elements
   differ) as three planes, as channels-last images and in identity mode
   (the images of the gathered planes, as the 'auto' route takes K1's) on
   the selection, an odd K, int32 indices, NaN pixels, repeated pairs with
   unselected bases, one base 150 times, K=1 of M=1, ragged squares (33^2,
   100^2, 127^2) and, launched directly with variants 0 and 1, 33 x 128 and
   128 x 127; time per call (K1's scan for its outputs inside the call)
   and bound; K3's wrapper, images wrapper, kernel launched directly in
   each layout and in identity mode, beside torch.Tensor.copy_ of the
   images' bytes; a bad index passed to K3 makes a subprocess exit
   non-zero; then the same above 128 x 128 (K2 and K1 on the
   resident-group kernel or, where its slabs do not fit, the strip kernel
   and, for K1, the strip K2 and K3's gather; K3 as above at the 256^2
   selection, 8 x 1024^2, one 2048^2 patch, 129 x 130 and 1000 x 1024,
   and timed at 256^2): 32 and 512 x 256^2, 8 x 1024^2, real, NaN,
   constant, 129 x 130 and 1000 x 1024, misaligned, one 2048^2 patch,
   each also on both kernels launched directly (the wrapper and both
   within 2e-5, all three equal element for element), the kernels a call
   launches (torch.profiler: each of the route's kernels once a call, K3's
   gather only on K1's strip route), K2's group kernel on a real 2048^2
   patch (512 slabs) on two streams at once, equal to a call alone, and both
   routes' times at (32, 256, 256), at the static selections of patch 256
   (M=128 base patches, K=480) and 1024 (M=8, K=30), and at 2048 (M=2,
   K=7), where no slab fits;
8. static prep, Preprocessor.create_dataset(static_num_patches=1920), on
   the 'auto' route (K1) and the 'planes' route (K2 + K3), and with MAD
   flags (K5), then on real input (the waterfalls' amplitudes) on both
   routes and on the materialised path (num_patches=1920, K4), each
   against use_kernels=False on the card: the same selection, labels
   bit-equal, images within 2e-5; and the 'auto' (K1) and 'planes' (K2 +
   K3) routes at patch_size=256 (K=480) and 1024 (K=30 of two 2048^2
   waterfalls), on the resident-group kernel, and at patch_size=2048 (K=7
   of one 2048 x 4096 waterfall), on the strip kernel (K1 as the strip K2
   and K3); each route's launches exact (K1 and K3 once on 'auto', K2
   and K3 once on 'planes', K5 too with MAD flags, K4 alone on the
   materialised path), and on 'auto' and 'planes' at patches 128 and 256
   no aten stack, cat, where or copy_ whose output has the images' shape
   (torch.profiler, record_shapes and profile_memory; the old epilogue's
   stack and where, run beside as a control, are seen);
9. the training main path at full width: the port's generator (bench.py's
   event mix) -> static prep (K=1920, default route) -> UNet(32,
   norm="batch") in bfloat16 trained for 15 steps of 128 per iteration;
   patches/s of the loop (median and spread of 3 windows), train-only
   patches/s and TFLOP/s against the bf16 peak, K1 and K3 launches (one
   each per iteration), every loss finite and falling; and two float32 steps
   (TF32 off) on 8 images each on the card and on the CPU from the same
   seeded weights: both losses within 1e-4 relative, the card's first
   gradient at most twice as far from a float64 CPU gradient as the
   CPU's float32 one, and the optimiser on the card, fed the CPU's
   gradients, within 1e-3 * lr of the CPU's parameters;
10. K6a (conv3x3_call) on the 18 conv layers of the folded UNet16 snapshot
    at batch 128, each on its real input (captured by forward hooks from
    phase 5's images): against its plain version and the cuDNN layer
    (within 1e-5 of the layer's max |y|), times of the kernel, the plain
    version and cuDNN's fused conv+bias+ReLU, and each layer's bound
    (Winograd's products, ``WINOGRAD_M``, at 3xTF32's rate on the tensor
    cores), under which none of the three times may fall; then the
    predictor's own route (``route == "k6a_nhwc"``, the channels-last
    forward of ``models/nhwc_forward.py``): 18 K6a launches a forward of
    128 and 72 in one flag_waterfalls call, its logits within 2e-4 of
    the eager cuDNN forward (TF32 off) on 512 images, its masks equal
    wherever the eager probability is clear of the cut by more than that
    gap, IoU > 0.9; the route's and the eager forward's distances from a
    float64 copy of the model are logged;
11. the same for K7 (double_conv_gn_relu) on the 9 DoubleConvs of the
    GroupNorm UNet16 snapshot, against its plain version and the port's
    DoubleConv eval forward (within 1e-4); then the predictor's own route
    (``route == "k7_nhwc"``, ``models/nhwc_groupnorm.py``): 9 K7 launches
    a forward of 128 and 36 in one flag_waterfalls call, logits within
    1e-3 (the coherent cell's limit), masks and IoU as for K6a;
12. one float32 UNet32 training step at batch 128 with every conv3x3
    through the differentiable conv3x3 (K6a forward and dx, K6b dW)
    against the same step through cuDNN (TF32 off) from the same weights:
    loss within 1e-4 relative, the gradients within 1e-3 in relative L2
    together, each parameter's as close to a float64 step's as cuDNN's
    (2x, or 1e-4); K6b per layer against its plain version and cuDNN's
    weight-gradient-only backward, its times and bounds, and two runs
    bit-equal;
13. train -> export -> serve: Trainer.fit of a bf16 UNet32 for one epoch
    of the K=1920 static dataset (batch 128, 15 fused steps, 256
    validation patches), export_params, CompiledPredictor.from_snapshot
    and flag_waterfalls on phase 5's waterfalls, whose flags agree with
    Trainer.predict on >= 99.9% of the pixels; predict(tta=True); a
    checkpoint restored bit-equal, and the next step bit-equal with
    deterministic algorithms;
14. the file path at full width: SyntheticDataGenerator on
    configs/data_generation/synthetic_train_4k.yaml's sections
    (``TRAIN_4K_CONFIG``: 1024 x 1024, 2 pols, its event counts, bandpass
    order 8, 4 rotations; 16 samples, one generation batch, and the MAD
    masks) and synthetic_val_1k.yaml's (``VAL_1K_CONFIG``, 4 samples)
    under build/chip_smoke/, then Trainer.fit on the streamed
    ``exact_masks`` directories (UNet32 bf16 BatchNorm, 1 epoch, batch 4):
    the files and counts against the metadata (128 images of 1024^2 in 2
    batch files, 32 MAD-mask waterfalls), K4 once and K5 once a generation
    batch, the MAD masks bit-equal to K5's plain version on the file's
    magnitudes, at most 3 batch files resident, all 128 samples consumed,
    finite losses, the validation IoU, the reader; generation and train
    times and patches/s, and the writer alone on one batch file's arrays
    from the card (its copy must equal the file);
15. the raw-patch path: DevicePreprocessor on phase 5's 8 waterfalls and
    masks at the default patch_size=256, then RawPatchTrainer (UNet32 bf16)
    for one epoch at batch 32: K4 once a step on (32, 256, 256), finite
    losses; then ``RAW_WARM_EPOCHS`` warm epochs timed back to back for
    patches/s;
16. the coherent simulator: ``RFISimulator`` draws 8 samples of 4 pols x
    1024^2 on the card and renders them with Gibbs ringing off, then on;
    the mask must be its draws' truth (``simulator_truth``: each family's
    amplitudes above the floor) and, rendered again on the CPU from the
    same draws (2 samples), masks equal outside the floor band and planes
    within 1e-5 of |field| plus 1e-6 of the pixel's summed amplitudes;
    ms a sample and each family's masked share;
17. physics gates on the port's own stream: (a) the seven coherent
    snapshots at 256^2 and their ``best_threshold`` on 8 held-out batches
    of 8 (``coherent_batch``, seeds 10000 + j) against
    tests/test_pretrained.py's floors, TTA too where the gate has one
    (and above the plain IoU); (b) ``unet16gn_universal.npz`` through
    flag_waterfalls(method="model") (K4 once) on the RR planes of phase
    16's 8 waterfalls: IoU >= 0.87;
18. flag_waterfalls_coherent on phase 16's planes (8 baselines x 4 pols x
    1024^2, patch 128: 512 images of 128^2 x 8) with unet24gn (GroupNorm)
    and unet16 (BatchNorm, folded) through CompiledPredictor at batch
    128: IoU, waterfalls/s, the images' and the predictor's ms; masks
    equal to a CPU run on one baseline on >= 99.9% of the pixels, also
    for a ragged 1000 x 1024 case (the statistics leave the padding out);
    for unet24gn, phase 11's K7 checks on its own shapes (8 channels in,
    widths 24-384, groups of 3, 6 and 12 channels): each DoubleConv's
    input captured from the eager forward at batch 128, K7 against its
    plain version and the module (within 1e-4), then its route
    (``"k7_nhwc"``): 9 K7 launches a forward and 36 in one call, logits
    within 2x the eager forward's distance from a float64 forward (or
    1e-3) of it (on these planes the eager float32 forward is itself
    ~1.4e-3 from float64), masks off the cut equal;
19. CoherentTrainer's flagship recipe (UNet24 GroupNorm, 256^2, batch 16,
    bf16, generation on the card): 60 steps with a checkpoint at 30,
    losses finite and falling; a trainer restored from the checkpoint
    repeats steps 31-60 (deterministic cuDNN) within rtol 1e-5 and atol
    1e-6 of params and EMA; 20 steps timed for steps/s, with the sample
    batch and the step apart; export -> CompiledPredictor.from_snapshot
    against CoherentTrainer.load(...).evaluate(num_batches=1);
20. the shipped SOLOLite detector (``pretrained/sololite_synthetic.npz``:
    features 48, embed 48, grid 8, patch 128) through
    InstanceTrainer.load: card against CPU (TF32 off) on 8 held-out images
    (classes and kept detections equal, scores within 1e-4, masks on >=
    99.9% of the pixels); tests/test_instance_quality.py's held-out gates
    by evaluate_instance_model on 256 images a mix of the port's stream
    (default mix at score 0.3: recall >= 0.70, n_gt > 640; all six
    families at 0.25: recall within 3 standard errors of the detector's
    float32 recall on JAX's stream, ``INST_REF_RECALL``, the JAX gate's
    0.80 printed beside, precision >= 0.80, every family present and at
    >= 0.70, n_gt > 1200), K4 once an evaluation batch of 64; the
    forward's and the decode + Matrix-NMS's ms per batch of 64;
21. InstanceTrainer at the shipped recipe (SOLOLite f=48, patch 128,
    batch 64, float32, the default mix, warmup-cosine 1e-5 -> 8e-4 ->
    1e-5), generation on the card: 60 steps in groups of 10, K4 once a
    step, losses finite and the last 10's mean below the first 10's; a
    checkpoint at 30 restored repeats steps 31-60 within rtol 1e-5 / atol
    1e-6 (deterministic cuDNN); one float32 step of 8 on the card against
    the CPU (phase 9's bounds, with phase 12's floor of 1e-4 on the
    gradient's distance to float64); one step with a quarter of the batch
    replaced by phase 5's patches; 20 steps timed for steps/s, the sample
    batch and the step apart; save -> InstanceTrainer.load -> predict
    equal to the trainer's own.
22. the measurement-set path on a VLA-sized scan (``VLA_MS``: 27 antennas,
    351 baselines, 4 pols, 2 SPWs of 256 channels joined into 512, 128
    integrations; 92.0 M visibilities, 1.47 GB of complex128 DATA) in the
    port's FakeMS, filled in place by inject_synthetic_data with
    RFISimulator waterfalls made on the card (their masks the truth):
    flag_measurement_set in bulk with method "mad" (K5), "model" (K4 +
    UNet16) and "model8" (the GroupNorm coherent UNet16), the FLAG column
    reset in place between runs; each written column equal to
    flag_waterfalls (or flag_waterfalls_coherent) on the card on
    MSLoader.load()'s data, and to the CPU's on 8 baselines (mad bit-equal,
    the models on >= 99.9% of the pixels); use_pallas=False's mad flags
    equal K5's; Mvis/s and the split of each run (load, to the card, card,
    to the host, save); the copy to the card from pageable and from pinned
    memory; IoU against the simulator's masks (no floor); compute_statistics,
    compute_ffi and compute_calcquality of the mad flags on the card (ms)
    against the CPU (medians and MADs bit-equal, the rest within 1e-5
    relative or 1e-6);
23. BASELINE config 5 (bench.py:675-697, ``CONFIG5_MS``): mad in bulk and
    streaming, flags bit-equal, Mvis/s each; merge_existing keeps flags set
    before; a ragged MS falls back to the streaming path and flags every
    baseline; config 1 (bench.py:456-524): make_sample_generator B=4 x
    1024^2 -> flag_waterfalls(mad) -> compute_ffi, waterfalls/s over 3
    windows;
24. the command-line path, each command's ``main(argv)`` in this process
    under ``CLI_ROOT`` (removed after): (a) generate_rfi_dataset, 16 + 4
    samples of 1024^2 in batches of 4 (0.66 GB): the file tree, shapes
    and dtypes, sample 0 bit-equal to generate_rfi_device with the same
    generator, s a sample split into the card's part and the writes';
    (b) normalize_rfi_data robust_scale on the validation split, equal to
    normalize_array; (c) train_rfi_model --config unet_default.yaml
    --batch_size 8 (UNet32 bf16 on 8 x 1024^2, 8 input channels) for 2
    epochs, then --checkpoint_path to epoch 3: finite losses, s an epoch,
    images/s; (d) evaluate_rfi_model on (c)'s checkpoint, with and without
    --tta, and on unet16_coherent8ch.npz over 2 normalized samples, card
    against --device cpu within 1e-4; (e) --instance at the recipe (f=48,
    patch 128, batch 64) for 40 steps, checkpoints every 20, export, then
    --auto_resume from step_40.pt to 60; evaluate_rfi_model --instance on
    the export and on sololite_synthetic.npz with the all-six mix, each
    equal to evaluate_instance_model(InstanceTrainer.load(...)); K4 once a
    step and an evaluation batch; (f) --coherent (UNet24, 256^2, batch 16)
    40 steps, export, --auto_resume to 60; evaluate_rfi_model --coherent
    on the export and on unet24gn_coherent8ch.npz over phase 17(a)'s 64
    samples at its threshold, held to phase 17(a)'s floor; (g)
    --mesh_shape 2,1 refused; (h) visualize_rfi_data's predictor against
    Trainer.predict (the drawing is left to the CPU tests);
25. the mesh paths (``rfi_toolbox_tpu_torch.parallel``) at world size 1
    on the card, through a real NCCL process group
    (``initialize_distributed`` with a coordinator on localhost; the
    driver's run has one card, and NCCL refuses two ranks on one device,
    so the multi-rank contract is held by the gloo tests on the CPU):
    (a) ``Trainer(mesh_shape=(1, 1))`` against ``Trainer()`` at
    configs/training/unet_dp_tp.yaml's width (unet_bigger, init_features
    32, 8 input channels, batch 64 at 128^2), 2 epochs of 3 steps in
    bf16 and in float32 (deterministic cuDNN): losses within 1e-5,
    parameters within lr / 2 and 99% within lr / 100 (the gaps printed),
    steps/s of the second epoch with and without the mesh; (b)
    flag_waterfalls(mesh=) mad (K5) and model (K4) on the 8 waterfalls
    and on one alone, flags bit-equal to the meshless ones (and K5's to
    its plain version); (c) preprocess_sharded (K4) within 2e-5 of the
    plain extraction, sharded_global_stats' median of |z| bit-equal to the
    mean of the two middle values of a torch.sort; (d) CoherentTrainer(mesh=)
    at the flagship recipe and InstanceTrainer(mesh_shape=(1,)) at the
    shipped one, 3 steps each, equal to their meshless runs; (e)
    train_rfi_model --config unet_dp_tp.yaml --mesh_shape 1,1 cut to one
    epoch of 3 steps, and --mesh_shape 2,1 refused.

Waterfalls/s is timed on the host clock over 3 windows of at least
``WINDOW_S`` seconds each (calls queued back to back, one synchronize at
the end of a window); the median and the spread of the windows are
printed.

The waterfalls are Gaussian noise with injected RFI stripes and blocks,
made with numpy from a fixed seed, so the exact mask is known. The
launch counts are set to 0 just before each path's run and read just
after it. The line before the last is one JSON object with each kernel's
launches, error, times and bound (K6a, K6b and K7 summed over their
layers; the line before it lists the layers); the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX. Budget: under
10 minutes with the build (phase 22 some 3 minutes, most of it the CPU's
sorts of 92 M entries; it holds some 6 GB of host memory). Writes only
under build/ (the snapshot and checkpoints of phases 13 and 19, phase
14's batch files, some 1.8 GB, phase 24's dataset and checkpoints, some
0.8 GB, deleted at the end of each phase).
"""

import collections
import concurrent.futures
import copy
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20260817
N_WATERFALLS, SIDE, PATCH = 8, 1024, 128
SIGMA = 5.0
K4_TOL = 2e-5
LOGIT_TOL = 2e-3  # f32 card vs f32 CPU: conv summation order differs
SNAPSHOTS = ("pretrained/unet16_synthetic.npz", "pretrained/unet16gn_universal.npz")
BATCH = 128  # the predictor's fixed batch
WINDOW_S = 1.0  # least host seconds of one timed window of flag_waterfalls
WINDOWS = 3
# H100 SXM data sheet: HBM rate, the float32 rate outside the tensor cores
# and the dense TF32 rate of the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# the fastest the card does float32-accurate products: 3xTF32 on the tensor
# cores (three TF32 products each, as K6b and K7 do), or the scalar rate
F32_PRODUCT_OPS_PER_S = max(SCALAR_OPS_PER_S, TF32_OPS_PER_S / 3)
# Operations of K4's function a pixel: the exact |z| (~25), log10 (~20),
# atan2 (~40), one gradient (~10), its min/max, the window and the affines
# (~20). A count of 40 left out the work inside log10 and atan2, as
# PLANE_OPS_PER_PIXEL's 60 did. The bound is by bytes at either count.
K4_OPS_PER_PIXEL = 115
# A 3x3 conv's bound counts the products of the fewest-multiplication exact
# algorithm a float32 library runs, not the direct ones: Winograd's minimal
# filtering F(m x m, 3 x 3) takes (m + 2)^2 products for an m x m tile of
# outputs (of pixels, for dW) per (Ci, Co) pair, against 9 m^2 direct. m = 6
# is the largest tile in float32 use (NNPACK's 8 x 8-tile Winograd); larger
# tiles lose float32 accuracy. Transforms are not counted: a floor. The
# products are counted at F32_PRODUCT_OPS_PER_S.
WINOGRAD_M = 6
# What K5's design spends, not what its function needs (an exact median
# and MAD take a few operations per pixel, so K5 is bound by its bytes):
# 2 radix selects x (4 passes of 8 bits x (2 to test the prefix, 2 for the
# digit, 1 shared atomic) + 2 for the least key above the lower rank), plus
# 8 to form a key of |x - median| at each of the MAD select's 6 reads
K5_DESIGN_OPS_PER_PIXEL = 2 * (4 * 5 + 2) + 6 * 8
# the training main path (bench.py:main)
RFI_CONFIG = {
    "narrowband_persistent": {"count": 20},
    "broadband_persistent": {"count": 5},
    "narrowband_bursty": {"count": 20},
    "broadband_bursty": {"count": 5},
    "frequency_sweep": {"count": 1},
}
K_STATIC = 1920  # static patches per iteration
TRAIN_BATCH = 128
STEPS = K_STATIC // TRAIN_BATCH
EXTRACT_TOL = 2e-5
F32_LOSS_RTOL = 1e-4  # card vs CPU, float32, TF32 off
OPT_ATOL_LR = 1e-3  # optimiser on the card vs CPU, same gradients, in lr
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16
# the conv kernels against their plain versions and cuDNN, as a share of the
# layer's max |y|: float32 sums of up to 9 * 512 terms in another order
CONV_RTOL = 1e-5
K7_RTOL = 1e-4  # GroupNorm divides by the group's std: 10x K6a's
DW_RTOL = 1e-4  # dW sums 128 * 128^2 * 9 products per value
TRAIN_LOSS_RTOL = 1e-4  # the float32 UNet32 step through K6a + K6b vs cuDNN
# float32 gradients of UNet32 are ~2e-4 off float64 in norm (phase 9), and a
# BatchNorm scale's gradient, a sum that cancels, far more: so all the
# gradients together are held to cuDNN's, and each parameter's to float64
# as closely as cuDNN's (2x, or 1e-4 where cuDNN lands closer than 5e-5)
GRAD_RTOL = 1e-3  # all parameters, relative L2, against cuDNN's step
GRAD_F64_FLOOR = 1e-4
MASK_AGREE = 0.999  # share of pixels two forwards must flag alike
ROUTE_LOGITS_ATOL = 2e-4  # the predictor's route against its eager forward (the benchmark's limit)
# the same for the GroupNorm route. First 2e-4, as for K6a; the card read 2.37e-4
# on unet16gn_universal (H100, 700 W), where a float64 forward puts the route
# 2.44e-4 off and the eager forward 3.2e-5: the gap is K7's own error (it sums
# each conv's chain in one truncating accumulator), as on unet24gn (the route up
# to 2.8e-4 from float64, the eager forward up to 2.2e-4). So the coherent cell's
# limit (benchmark/limits/flag_unet24gn_coherent.json): a wrong kernel moves
# logits of order 20 by far more. Phases 11 and 18 log both distances from a
# float64 forward beside the gap.
K7_ROUTE_LOGITS_ATOL = 1e-3
# Phase 18's planes: there the eager float32 forward of unet24gn itself lies 1.41e-3
# from float64 (the route 1.67e-3, the two 1.85e-3 apart; H100, 700 W), so the route
# is held to float64 within 2x the eager forward's distance, as phase 12 holds each
# gradient (or within K7_ROUTE_LOGITS_ATOL where that is wider)
K7_ROUTE_F64_RATIO = 2
# Phase 14: configs/data_generation/synthetic_train_4k.yaml and
# synthetic_val_1k.yaml as dict literals (the card has no PyYAML;
# tests/test_torch_generator.py holds them to the files), each cut as
# PHASE14_CUTS says and in nothing else: the widths (1024 x 1024, 2 pols),
# the event counts, the bandpass (order 8), the 4 rotations and the
# generation batch of 16 are the published ones
_EVENTS = {"narrowband_persistent": 20, "broadband_persistent": 5, "frequency_sweep": 1,
           "narrowband_bursty": 20, "broadband_bursty": 5}
_SYNTH = {"num_channels": 1024, "num_times": 1024, "noise_mjy": 1.0,
          "rfi_power_min": 1000.0, "rfi_power_max": 10000.0, "rfi_type_counts": _EVENTS,
          "enable_bandpass_rolloff": True, "bandpass_polynomial_order": 8,
          "polarization_correlation": 0.8, "num_polarizations": 2,
          "generation_batch_size": 16}
_PROC = {"normalize_before_stretch": False, "normalize_after_stretch": False,
         "stretch": None, "flag_sigma": 5, "patch_size": 1024}
_TRAIN_4K = {"synthetic": {**_SYNTH, "num_samples": 4000},
             "processing": {**_PROC, "enable_augmentation": True, "augmentation_rotations": 4}}
_VAL_1K = {"synthetic": {**_SYNTH, "num_samples": 1000},
           "processing": {**_PROC, "enable_augmentation": False, "augmentation_rotations": 1}}
# 4000 samples -> 16 (one generation batch: 128 images of 1024^2 in 2 batch
# files), with the MAD masks (K5 on the 32 whole waterfalls); 1000 -> 4
PHASE14_CUTS = {
    "TRAIN_4K_CONFIG": {"synthetic": {"num_samples": 16, "generate_mad_masks": True}},
    "VAL_1K_CONFIG": {"synthetic": {"num_samples": 4}},
}


def simulator_truth(sim, d):
    """What the simulator's draws ``d`` say without its render.

    Returns ``(masks, band, amp)``: each family's mask (pixels its events
    reach with an amplitude above the floor: the render's rule, up to
    |exp(i phi)| = 1 in float32); ``band``, the pixels where an event's
    amplitude lies within ``MAG_RTOL`` relative of the floor, which that
    rounding may tip either way; and ``amp`` (n, 4, T, F), the sum of the
    event amplitudes that reach each pixel of each pol (through the
    ringing kernel's |taps|), which bounds what the rounding of the
    phases' sines and cosines and the order of the sums can move.
    """
    n, T, F = d["bl"].shape[0], sim.time_bins, sim.freq_bins
    dev = d["bl"].device
    power = torch.as_tensor(sim.power_range, device=dev)
    floor = sim.detect_floor
    b = torch.arange(n, device=dev)[:, None, None]

    def plane(dtype=torch.float32):
        return torch.zeros((n, T, F), dtype=dtype, device=dev)

    def near(a):
        return (a - floor).abs() <= MAG_RTOL * floor

    bb = d["broadband"]
    f = torch.arange(F, device=dev)
    keep = ((f >= bb["start"][..., None]) & (f < (bb["start"] + bb["width"])[..., None])
            & (torch.arange(bb["start"].shape[1], device=dev) < bb["count"][:, None])[..., None])
    a_bb = bb["modulation"] * power[bb["power"]] * keep[:, :, None, :]
    masks = {"broadband": (a_bb > floor).any(1)}
    band = near(a_bb).any(1)
    sums = {"broadband": a_bb.sum(1)}
    del a_bb
    nb, tb = d["narrowband"], d["bursts"]
    for name, fam, at in (
            ("narrowband", nb, (b, torch.arange(T, device=dev), nb["index"][..., None])),
            ("bursts", tb, (b, tb["index"][..., None], torch.arange(F, device=dev)))):
        a = fam["modulation"] * power[fam["power"]][..., None]
        sums[name] = plane().index_put_(at, a, accumulate=True)
        masks[name] = plane(torch.int32).index_put_(at, (a > floor).int(), accumulate=True) > 0
        band |= plane(torch.int32).index_put_(at, near(a).int(), accumulate=True) > 0
    if sim.gibbs_ringing:
        taps = np.abs(sim._gibbs_kernel).tolist()
        h = len(taps) // 2
        for name, dim in (("broadband", -1), ("narrowband", -1), ("bursts", -2)):
            x = sums[name]
            pad = torch.nn.functional.pad(x, (h, h) if dim == -1 else (0, 0, h, h))
            sums[name] = sum(k * pad.narrow(dim, j, x.shape[dim]) for j, k in enumerate(taps))
    rr = sums["broadband"] + sums["narrowband"] + sums["bursts"]
    ll = rr.clone()
    lin, quad = d["linear"], d["quadratic"]
    half, quarter = T // 2, T // 4
    f_lin = torch.trunc(lin["start_f"][..., None] + lin["slope"][..., None] * torch.arange(
        half, dtype=torch.float32, device=dev)).long() % F
    t_lin = (lin["start_t"][..., None] + torch.arange(half, device=dev)) % T
    t = torch.arange(quarter, device=dev)
    f_quad = (quad["start_f"][..., None] + torch.div(
        torch.where(quad["direction"], 1, -1)[..., None] * t ** 2, 100,
        rounding_mode="floor")) % F
    t_quad = (quad["start_t"][..., None] + t) % T
    for name, fam, at, planes in (("linear", lin, (b, t_lin, f_lin), (rr, ll)),
                                  ("quadratic", quad, (b, t_quad, f_quad), (rr,))):
        a = power[fam["power"]]
        for p in planes:
            p.index_put_(at, a, accumulate=True)
        masks[name] = plane(torch.int32).index_put_(at, (a > floor).int(), accumulate=True) > 0
    # the cross hands add u * RR with u < 1
    return masks, band, torch.stack([rr, rr, rr, ll], dim=1)


def tree_to(tree, device, k):
    """The first ``k`` samples of a nested dict of tensors, on ``device``."""
    if isinstance(tree, dict):
        return {key: tree_to(v, device, k) for key, v in tree.items()}
    return tree[:k].to(device)


def cut_config(published, cut):
    """``published`` with each section's values replaced by ``cut``'s."""
    return {section: {**values, **cut.get(section, {})} for section, values in published.items()}


TRAIN_4K_CONFIG = cut_config(_TRAIN_4K, PHASE14_CUTS["TRAIN_4K_CONFIG"])
VAL_1K_CONFIG = cut_config(_VAL_1K, PHASE14_CUTS["VAL_1K_CONFIG"])
FIT_BATCH = 4  # the training CLI's default for --train_batches_dir
LARGE = 256  # the side of the large patches of phases 3, 5, 7 and 8
K_LARGE = K_STATIC * PATCH ** 2 // LARGE ** 2  # 480 of 256^2: the pixels of 1920 of 128^2
K_WIDE = K_STATIC * PATCH ** 2 // SIDE ** 2  # 30 of 1024^2 (of the 32 virtual patches)
# phases 7 and 8: patches of 2048^2, where no slab of the resident-group kernel
# fits (the strip route): the 8 waterfalls tiled into one of 2048 x 4096, 7 of
# its 8 virtual patches
HUGE, K_HUGE = 2048, 7
FLAG_BATCH_LARGE = 32  # the predictor's fixed batch at 256^2
RAW_PATCH, RAW_BATCH = 256, 32  # phase 15: create_raw_patches' default, batch 32
RAW_WARM_EPOCHS = 20  # phase 15: the warm epochs timed back to back
# Phases 16-19: the coherent 8-channel path. The simulator's waterfalls are
# its default planes, SIDE x SIDE, N_WATERFALLS of them (8 baselines).
MAG_RTOL = 1e-5  # simulator planes, card vs CPU (plus the rounding bound, below)
# phase 17(a): tests/test_pretrained.py's held-out floors, (plain, TTA)
COHERENT_GATES = {
    "unet16_coherent8ch": (0.83, None),
    "unet24_coherent8ch": (0.86, 0.865),
    "unet24gn_coherent8ch": (0.925, 0.928),
    "unet16gn_coherent8ch": (0.924, 0.926),
    "unet32gn_coherent8ch": (0.929, 0.930),
    "unet16gn_s2d_coherent8ch": (0.925, 0.927),
    "unet24gn_s2d_coherent8ch": (0.926, 0.928),
}
HELD_OUT_KEY, GATE_BATCHES, GATE_BATCH = 10_000, 8, 8  # batch j seeded HELD_OUT_KEY + j
UNIVERSAL = "pretrained/unet16gn_universal.npz"
UNIVERSAL_FLOOR = 0.87  # phase 17(b); pretrained/README.md records 0.9101 on a TPU
COHERENT_FLAGGERS = ("unet24gn_coherent8ch", "unet16_coherent8ch")  # phase 18
CPU_PREDICT_BATCH = 32  # the CPU predictors' batch (64 images a baseline)
RAGGED_C = 1000  # phase 18's ragged case: 1000 x 1024
# phase 19: the flagship recipe (pretrained/README.md: unet24gn_coherent8ch),
# bfloat16 on the card; 60 steps, a checkpoint at 30
COHERENT_RECIPE = {"init_features": 24, "size": 256, "batch_size": 16, "norm": "group"}
COH_STEPS, COH_CKPT, COH_TIMED = 60, 30, 20
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6  # tests/test_coherent_trainer.py's
# Phases 20-21: the SOLOLite instance path. Phase 20 serves the shipped
# detector and holds it to tests/test_instance_quality.py's held-out floors
# on the port's own stream: INST_IMAGES images a mix (4x the JAX all-six
# gate's 64), batch j of INST_BATCH drawn from a generator seeded
# INST_HELD_OUT + j. Seeds and counts are fixed before the first run.
SOLOLITE = "pretrained/sololite_synthetic.npz"
INST_IMAGES, INST_BATCH, INST_HELD_OUT = 256, 64, 10_000
ALL_SIX = {
    "narrowband_persistent": {"count": [1, 3]},
    "broadband_persistent": {"count": [0, 2]},
    "narrowband_intermittent": {"count": [0, 2]},
    "narrowband_bursty": {"count": [0, 2]},
    "broadband_bursty": {"count": [0, 1]},
    "frequency_sweep": {"count": [0, 1]},
}
# The shipped detector's float32 recall on the all-six mix: 2048 images of
# JAX's stream on the CPU (tests/instance_quality_cpu.py). The JAX gate's
# recall floor of 0.80 sits on this mean (its 0.822 record is one 64-image
# sample's), so a 256-image sample misses it about half the time whatever
# the port does. Phase 20 holds the card's all-six recall to this
# reference within 3 binomial standard errors of its sample, and prints
# the 0.80 floor beside it; every other floor is the JAX gates'.
INST_REF_RECALL = 0.8003
# the JAX gates' floors, n_gt scaled by 256/16 and 256/64
INSTANCE_GATES = {
    "default": {"rfi_config": None, "score": 0.3, "recall": 0.70, "n_gt": 640},
    "all six": {"rfi_config": ALL_SIX, "score": 0.25, "recall": 0.80,
                "recall_reference": INST_REF_RECALL, "precision": 0.80, "family": 0.70,
                "families": 6, "n_gt": 1200},
}
INST_TOL = 1e-4  # phase 20: scores, card vs CPU (TF32 off)
# phase 21: cli/train_model.py's --instance recipe (the shipped detector's
# widths, patch 128, batch 64, float32, the default mix, its warmup-cosine
# schedule for the run's length); 60 steps, a checkpoint at 30
INST_MODEL = {"num_classes": 6, "grid_size": 8, "features": 48, "embed_dim": 48}
INST_STEPS, INST_CKPT, INST_TIMED = 60, 30, 20
INST_CHECK_LR, INST_CHECK_BATCH = 8e-4, 8  # the card-vs-CPU step: the recipe's peak rate
# Phases 22-23: the measurement-set path. Phase 22 flags a VLA-sized scan
# (27 antennas: 351 cross baselines, 4 pols, 2 SPWs of 256 channels that the
# loader joins into 512, 128 integrations: 92.0 M visibilities) held in the
# port's FakeMS and filled by the RFISimulator on the card. A cut, if the
# time limit ever forces one, takes integrations only and is printed.
VLA_MS = {"num_antennas": 27, "channels_per_spw": (256, 256), "num_times": 128,
          "num_pols": 4}
MS_SEED = 20261017
MS_CPU_BASELINES = 8  # baselines flagged on the CPU too
MODEL8_SNAPSHOT = "pretrained/unet16gn_coherent8ch.npz"
# statistics, card vs CPU: medians and MADs bit-equal, the rest float32
# sums in another order (tests/test_torch_statistics.py's tolerance)
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6
# Phase 23: BASELINE config 5 (bench.py:675-697) and config 1
# (bench.py:456-524) at their own sizes
CONFIG5_MS = {"num_antennas": 5, "channels_per_spw": (256,), "num_times": 256, "seed": 1}
CONFIG1_B = 4
CONFIG1_EVENTS = {"narrowband_persistent": {"count": 20}, "broadband_persistent": {"count": 5},
                  "narrowband_bursty": {"count": 20}, "broadband_bursty": {"count": 5},
                  "frequency_sweep": {"count": 1}}
# Phase 25: the mesh paths at world size 1 (see the docstring). unet_dp_tp.yaml's
# model at its width, batch 64 at 128^2 (its dataset's patch size), cut in depth
# to 2 epochs of PAR_STEPS steps
PAR_SEED = 20261018
PAR_STEPS, PAR_LR = 3, 1e-4
PAR_MODEL = {"model_type": "unet_bigger", "in_channels": 8, "init_features": 32}
PAR_BATCH, PAR_SIDE = 64, 128
PAR_RECIPE_STEPS = 3  # (d): the coherent and instance recipes' steps
PAR_TOL = 2e-5  # (c): the extraction's bound
# Phase 24: the command-line path. generate_rfi_dataset at its published
# widths (1024 x 1024, the command's defaults), cut in depth from 1000 + 200
# samples to 16 + 4 (0.66 GB on disk); train_rfi_model at
# configs/training/unet_default.yaml's width (UNet32 bf16), its batch of 32 cut
# to 8 (at 32 one bf16 activation of 32 channels at 1024^2 is 2.1 GB, and the
# first and last stages hold 15-25 of them with the backward pass) and its 50
# epochs to 2, then 1 more resumed; the --instance and --coherent recipes at
# their widths, cut from 36 000 steps to 40, then 20 more resumed.
CLI_ROOT = Path("build/chip_smoke_cli")
CLI_SEED = 20261017
CLI_SAMPLES = (16, 4)  # training, validation
CLI_SIDE, CLI_GEN_BATCH, CLI_TRAIN_BATCH, CLI_EPOCHS = 1024, 4, 8, 2
CLI_STEPS, CLI_CKPT, CLI_STEPS_RESUMED = 40, 20, 60
CLI_EVAL_IMAGES = 64  # the instance evaluations' held-out images
CLI_EVAL_SNAPSHOT, CLI_EVAL_SAMPLES = "pretrained/unet16_coherent8ch.npz", 2
CLI_DEVICE_TOL = 1e-4  # evaluate_rfi_model's metrics, card vs CPU (TF32 off)
CLI_COHERENT_SNAPSHOT = "pretrained/unet24gn_coherent8ch.npz"
ALL_SIX_YAML = "configs/evaluation/all_six_events.yaml"
# Operations of K1's and K2's function a base pixel: the exact |z| (a
# division, a float64 FMA, a square root: ~25), log10 (~20), atan2 (~40),
# three gradients (~30), min/max, windows and affines (~35). A count of 60
# leaves out the work inside log10 and atan2, which was 40-45% of the time
# of the one-block-per-patch kernels (PERF.md). The bound is by bytes at
# either count.
PLANE_OPS_PER_PIXEL = 150


def direct_gflop(n, h, w, ci, co):
    """GFLOP of a direct 3x3 conv, its dx or its dW (2 * 9 * Ci * Co a
    pixel): the work that "direct-equivalent TFLOP/s" divides."""
    return 2 * 9 * n * h * w * ci * co / 1e9


def hmma_expected(mangled):
    """The tensor-core TF32 MMAs a 3xTF32 kernel's SASS must hold, read off
    its tile's template arguments (``Li<n>E`` in the mangled name): three
    (lo*hi, hi*lo, hi*hi) for every m16n8 tile of its unrolled loop body.
    K6b's DwTile<CO_T, WM, WN, NT, XS>: CO_T / (16 WM) x NT tiles a warp,
    the 9 taps inside NT; conv3x3_mma_kernel<Tile<TH, TW, CO_T, WM, WN>,
    kStats, kGnIn, kChunkSums> (K7: kChunkSums false, K6a: false, false,
    true): TH TW / (16 WM) x CO_T / (8 WN) tiles a warp, for each of the 3
    taps of a row (``#pragma unroll 1`` over the rows). None for another
    kernel. A kernel that fell back to single TF32 holds a third."""
    args = [int(v) for v in re.findall(r"Li(\d+)E", mangled)]
    if "conv3x3_dw_kernel" in mangled:
        co_t, wm, _, nt, _ = args
        return 3 * (co_t // (16 * wm)) * nt
    if "conv3x3_mma_kernel" in mangled:
        th, tw, co_t, wm, wn = args[:5]
        return 3 * 3 * (th * tw // (16 * wm)) * (co_t // (8 * wn))
    return None


def kernel_report(lib, nvcc):
    """Print registers, spills and shared memory of the conv kernels, K5's
    and K1's, K2's and K4's from nvcc.log, and the tensor-core TF32 MMAs in
    the SASS of each; print how many clusters of 4 CTAs of K1's, K2's and
    K4's kernel fit on the card at 128 x 128 (cudaOccupancyMaxActiveClusters)
    and its dynamic shared memory, and fail if none fits for one of them or
    if one of its 12 instances is missing, or one of the resident-group
    kernel's 12 (K4, K2 and K1 above 128 x 128, with the CTAs it keeps
    resident: fail if none), the strip kernel's 16 or K3's 4 (with the
    CTAs it keeps resident: fail if none);
    fail if a 3xTF32 kernel (K6b's conv3x3_dw_kernel, K6a's and K7's
    conv3x3_mma_kernel) holds another count than hmma_expected's, or if
    K6a's four tiles (kChunkSums true) are missing."""
    text = (lib.path.parent / "nvcc.log").read_text()
    kernels = ("conv3x3_dw_kernel", "conv3x3_mma_kernel", "group_stats_kernel",
               "gn_relu_kernel", "sum_splits_kernel", "mad_flags_kernel",
               "cluster_extract_kernel", "group_extract_kernel", "strip_extract_kernel",
               "plane_gather_kernel")
    tool = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib.path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
        elif name and "HMMA" in line and "TF32" in line:
            hmma[name] = hmma.get(name, 0) + 1
    names = re.findall(r"Compiling entry function '(\S+)'", text)
    pretty = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                            text=True).stdout.splitlines() or names
    for mangled, readable, part in zip(names, pretty, re.split(
            r"Compiling entry function '\S+'", text)[1:]):
        if not any(k in mangled for k in kernels):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        smem = re.search(r"(\d+) bytes smem", part)
        readable = re.sub(r"^void |\(anonymous namespace\)::|rfi::mmaconv::", "", readable)
        want = hmma_expected(mangled)
        log(f"  {readable.split('(')[0][:90]}: {regs.group(1) if regs else '?'} registers, "
            f"spills {spill.group(1) if spill else '?'}/{spill.group(2) if spill else '?'} "
            f"bytes (stores/loads), static shared {smem.group(1) if smem else 0} bytes, "
            f"{hmma.get(mangled, 0)} HMMA.*.TF32 in its SASS"
            + (f" (3xTF32: {want})" if want is not None else ""))
        if want is not None:
            require(hmma.get(mangled, 0) == want,
                    f"{readable[:60]}: {hmma.get(mangled, 0)} tensor-core TF32 MMAs in its "
                    f"SASS, not 3xTF32's {want}")
    k6a = [r for r in pretty if "conv3x3_mma_kernel" in r and r.split("(")[0].endswith("true>")]
    require(len(k6a) == 4, f"K6a's tensor-core tiles: {len(k6a)} of 4 compiled")
    extract = [r for r in names if "cluster_extract_kernel" in r]
    require(len(extract) == 12,
            f"K1's, K2's and K4's kernel: {len(extract)} of 12 instances compiled")
    log("  (cluster_extract_kernel<complex, kind: 0 K2, 1 K1, 2 K4, pixels a group>)")
    strips = [r for r in names if "strip_extract_kernel" in r]
    require(len(strips) == 16, f"the strip kernel: {len(strips)} of 16 instances compiled")
    log("  (strip_extract_kernel<complex, kind: 0 K2, 2 K4, pixels a group, pass 2>)")
    gathers = [r for r in names if "plane_gather_kernel" in r]
    require(len(gathers) == 4, f"K3's kernel: {len(gathers)} of 4 instances compiled")
    log("  (plane_gather_kernel<TMA loads and 16-byte stores, pixel stride>)")
    fit = (ctypes.c_int * 3)()
    groups = [r for r in names if "group_extract_kernel" in r]
    require(len(groups) == 12,
            f"the resident-group kernel: {len(groups)} of 12 instances compiled")
    log("  (group_extract_kernel<complex, kind: 0 K2, 1 K1, 2 K4, pixels a group>)")
    for kind, name in ((1, "K1"), (0, "K2"), (2, "K4")):
        for is_complex in (1, 0):
            rc = lib.rfi_extract_groups_occupancy(kind, is_complex, fit)
            log(f"  {name} above 128^2 ({'complex64' if is_complex else 'float32'}): "
                f"resident-group kernel, {fit[0]} CTAs an SM at its {fit[2]} bytes of dynamic "
                f"shared memory, {fit[1]} resident on the card (rc {rc})")
            require(rc == 0 and fit[1] > 0, f"{name}: no CTA of the resident-group kernel fits")
    for fast in (1, 0):
        for stride in (1, 3):
            rc = lib.rfi_plane_gather_occupancy(fast, stride, fit)
            log(f"  K3 ({'TMA' if fast else 'per-thread loads'}, "
                f"{'planes' if stride == 1 else 'images'}): {fit[0]} CTAs an SM at "
                f"{fit[2]} bytes of dynamic shared memory, {fit[1]} resident on the card "
                f"(rc {rc})")
            require(rc == 0 and fit[1] > 0, "K3: no CTA fits")
    for kind, name in ((1, "K1"), (0, "K2"), (2, "K4")):
        for is_complex in (1, 0):
            rc = lib.rfi_channel_planes_occupancy(kind, is_complex, PATCH, PATCH, fit)
            log(f"  {name} ({'complex64' if is_complex else 'float32'}, 128^2): clusters of 4 "
                f"CTAs on the card at once {fit[1]}, CTAs an SM {fit[0]}, dynamic shared "
                f"{fit[2]} bytes a CTA (rc {rc})")
            require(rc == 0 and fit[1] > 0, f"{name}: no cluster of 4 CTAs fits on the card")


def conv3x3_flops(n, h, w, ci, co):
    """Flops (product + accumulation = 2) of a 3x3 conv, its dx or its dW
    over n x h x w pixels at Winograd F(6x6, 3x3)'s product count; a
    conv's bound takes them at F32_PRODUCT_OPS_PER_S."""
    return 2 * n * h * w * ci * co * (WINOGRAD_M + 2) ** 2 / WINOGRAD_M ** 2

T_START = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T_START:6.1f}s] {msg}", flush=True)


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bound(n_bytes, n_ops, ops_per_s=SCALAR_OPS_PER_S):
    """The least milliseconds the card takes to move ``n_bytes`` and do
    ``n_ops`` at ``ops_per_s``, and which of the two bounds it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = n_ops / ops_per_s
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def extract_err(got, want, what):
    """Max |kernel - plain| over the tensors of ``got`` and ``want`` where
    the plain version is not NaN; fails on another shape, or on NaN or inf
    where the plain version has no NaN."""
    worst = 0.0
    for a, b in zip(got, want):
        require(a.shape == b.shape, f"{what}: shape {tuple(a.shape)}, plain {tuple(b.shape)}")
        nan = torch.isnan(b)
        require(torch.equal(torch.isnan(a), nan) and bool(torch.isfinite(a[~nan]).all()),
                f"{what}: NaN or inf where the plain version has none")
        if bool((~nan).any()):
            worst = max(worst, float((a[~nan] - b[~nan]).abs().max()))
    return worst


def differing(got, want):
    """Elements that differ between two tuples of tensors (NaN equals NaN)."""
    return sum(int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
               for a, b in zip(got, want))


def k3_differing(planes, base_idx, pidx, variant):
    """Elements in which K3 differs from its plain version (NaN equals
    NaN): ``(planes, images, identity)``, the wrapper's three planes, the
    images wrapper's channels-last images, and the images wrapper's
    identity mode on the gathered planes (as the 'auto' route takes
    K1's) against the stack and transform it replaces."""
    from rfi_toolbox_tpu_torch import ops
    from rfi_toolbox_tpu_torch.ops import fused_channels as F

    want = ops.fused_plane_gather_transform_plain(planes, base_idx, pidx, variant)
    got = ops.fused_plane_gather_transform(planes, base_idx, pidx, variant)
    images = ops.fused_plane_gather_transform_images(planes, base_idx, pidx, variant)
    gathered = tuple(x.contiguous() for x in F._gather_planes(planes, base_idx, pidx))
    ident = ops.fused_plane_gather_transform_images(gathered, None, None, variant)
    want_ident = ops.fused_plane_gather_transform_images_plain(gathered, None, None, variant)
    torch.cuda.synchronize()
    return (differing(got, want), differing((images,), (torch.stack(want, -1),)),
            differing((ident,), (want_ident,)))


def k3_rect_diff(planes, base_idx, pidx, variant):
    """K3 on tiles of any h x w with variants 0 and 1 (as K1's strip route
    takes it), launched directly as planes and as images: the elements
    in which each differs from the row flip of the gathered planes."""
    from rfi_toolbox_tpu_torch.ops import fused_channels as F

    _, h, w = planes[1].shape
    k = base_idx.numel()
    idx = [x.to(torch.int32).contiguous() for x in (base_idx, pidx, variant)]
    want = tuple(torch.where((variant == 1)[:, None, None], x.flip(-2), x)
                 for x in F._gather_planes(planes, base_idx, pidx))
    out1 = torch.empty((3, k, h, w), device=planes[1].device)
    out3 = torch.empty((k, h, w, 3), device=planes[1].device)
    F._gather_transform(planes, *idx, out1, 1)
    F._gather_transform(planes, *idx, out3, 3)
    torch.cuda.synchronize()
    return differing(tuple(out1), want), differing((out3,), (torch.stack(want, -1),))


def k3_times(planes, base_idx, pidx, variant):
    """K3's ms a call at one shape (``cuda_ms``): the wrapper (three
    planes), the images wrapper, the kernel launched directly as planes
    and as images (indices and outputs made once), its identity mode on
    the gathered planes into images, and ``torch.Tensor.copy_`` of the
    images' bytes (what the card moves that traffic in)."""
    from rfi_toolbox_tpu_torch import ops
    from rfi_toolbox_tpu_torch.ops import fused_channels as F

    _, h, w = planes[1].shape
    k = base_idx.numel()
    dev = planes[1].device
    idx = F._gather_indices(k, dev, base_idx, pidx, variant)
    out1 = torch.empty((3, k, h, w), device=dev)
    out3 = torch.empty((k, h, w, 3), device=dev)
    gathered = tuple(x.contiguous() for x in F._gather_planes(planes, base_idx, pidx))
    src = torch.empty(k * h * w * 3, device=dev)
    dst = torch.empty_like(src)
    return {
        "wrapper": cuda_ms(lambda: ops.fused_plane_gather_transform(
            planes, base_idx, pidx, variant)),
        "images wrapper": cuda_ms(lambda: ops.fused_plane_gather_transform_images(
            planes, base_idx, pidx, variant)),
        "kernel": cuda_ms(lambda: F._gather_transform(planes, *idx, out1, 1)),
        "images kernel": cuda_ms(lambda: F._gather_transform(planes, *idx, out3, 3)),
        "identity kernel": cuda_ms(lambda: F._gather_transform(gathered, None, None, idx[2],
                                                               out3, 3)),
        "copy_": cuda_ms(lambda: dst.copy_(src)),
    }


# a subprocess that passes K3 a base_idx one past the last base patch,
# after a good call: the kernel traps, so it must exit non-zero
K3_BAD_INDEX = """
import sys
import torch
sys.path.insert(0, {root!r})
from rfi_toolbox_tpu_torch import ops
x = torch.polar(torch.rand(4, 64, 64, device="cuda") + 0.5, torch.rand(4, 64, 64, device="cuda"))
planes = ops.fused_extract_channel_planes(x)
idx = torch.tensor([0, 3, 1], device="cuda")
ops.fused_plane_gather_transform(planes, idx, idx % 3, idx % 4)
torch.cuda.synchronize()
print("good call ok", flush=True)
ops.fused_plane_gather_transform(planes, torch.tensor([0, 4, 1], device="cuda"), idx % 3, idx % 4)
torch.cuda.synchronize()
print("bad call returned", flush=True)
"""


def image_passes(fn, k, side):
    """The aten stack, cat, where and copy_ calls of ``fn()`` whose output
    has the images' shape (k, side, side, 3) float32, by torch.profiler
    (record_shapes, profile_memory): a stack, cat or where that allocates
    the images' bytes on the card, or a where or copy_ with an argument of
    that shape. Returns their names."""
    shape = [k, side, side, 3]
    n_bytes = 4 * k * side * side * 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True, profile_memory=True) as prof:
        fn()
        torch.cuda.synchronize()
    found = []
    for e in prof.events():
        name = e.name.split("::")[-1]
        if name not in ("stack", "cat", "where", "copy_"):
            continue
        allocates = name != "copy_" and e.device_memory_usage >= n_bytes
        if allocates or (name in ("where", "copy_") and shape in e.input_shapes):
            found.append(name)
    return found


def direct_kernel(kind, route, x, base_idx=None, pidx=None):
    """``(call, outputs, rows)``: ``call()`` launches K4's ("K4"), K2's or
    K1's kernel of ``route`` above 128 x 128 directly on ``x`` (no wrapper
    counts it) into ``outputs``, allocated once: "groups" the resident-group
    kernel at the ``rows`` ``group_rows`` gives the shape (``call`` None
    where no slab fits), "strips" the two-pass strip kernel (K1: the strip
    K2 into planes, then K3's gather)."""
    from rfi_toolbox_tpu_torch.ops import fused_channels as F

    n, h, w = x.shape
    code = {"K4": F._K4, "K2": F._K2, "K1": F._K1}[kind]
    plane_shapes = [(3, n, h, w), (n, h, w), (n, h, w)]
    shapes = {"K4": [(n, h, w, 3)], "K2": plane_shapes,
              "K1": [(0 if base_idx is None else base_idx.numel(), h, w)] * 3}[kind]
    if kind == "K1":  # one buffer of its three planes, as the wrapper's
        buf = torch.empty((3, *shapes[0]), device=x.device)
        outs = tuple(buf)
    else:
        outs = tuple(torch.empty(sh, device=x.device) for sh in shapes)
    idx = ()
    if kind == "K1":
        idx = (base_idx.to(torch.int32), pidx.to(torch.int32))
    if route == "groups":
        resident = F._resident(torch.cuda.current_device(), code, x.is_complex())
        rows = F.group_rows(h, w, x.is_complex(), resident)
        if not rows:
            return None, outs, 0
        return (lambda: F._extract_groups(code, x, rows, *outs, *idx)), outs, rows
    if kind == "K4":
        return (lambda: F._extract_strips(F._K4, x, *outs)), outs, 0
    if kind == "K2":
        return (lambda: F._extract_strips(F._K2, x, *outs)), outs, 0
    planes = tuple(torch.empty(sh, device=x.device) for sh in plane_shapes)
    variant = torch.zeros_like(idx[0])

    def call():
        F._extract_strips(F._K2, x, *planes)
        F._gather_transform(planes, *idx, variant, buf, 1)
    return call, outs, 0


def both_kernels(kind, x, base_idx=None, pidx=None):
    """``(rows, group outputs, strip outputs)`` of K4 ("K4"), K2 or K1 on
    ``x`` on both kernels (``direct_kernel``); the group outputs ``None``
    where no slab fits."""
    g_call, groups, rows = direct_kernel(kind, "groups", x, base_idx, pidx)
    if g_call is None:
        groups = None
    else:
        g_call()
    s_call, strips, _ = direct_kernel(kind, "strips", x, base_idx, pidx)
    s_call()
    return rows, groups, strips


def route_of(kind, x):
    """The route and rows ``extract_route`` gives K4 ("K4"), K2 or K1 on
    ``x``'s shape on this card."""
    from rfi_toolbox_tpu_torch.ops import fused_channels as F

    code = {"K4": F._K4, "K2": F._K2, "K1": F._K1}[kind]
    return F.extract_route(code, *x.shape[1:], x.is_complex(),
                           F._resident(torch.cuda.current_device(), code, x.is_complex()))


def route_kernels(kind, route):
    """The port's kernels (names before their template arguments) that a
    call of K4 ("K4"), K2 or K1 launches once each on ``route`` above
    128 x 128: the group route its one kernel; the strip route the key
    init and the strip kernel's two passes, and K1 there K3's gather too."""
    if route == "groups":
        return ["group_extract_kernel"]
    return (["init_keys_kernel", "strip_extract_kernel", "strip_extract_kernel"]
            + (["plane_gather_kernel"] if kind == "K1" else []))


def port_kernels(fn, want, calls=8, tries=4):
    """``(ok, counts, traces)``: whether ``calls`` calls of ``fn`` launch
    each of the port's kernels named in ``want`` (``route_kernels``) once
    a call and no other of the port's kernels (PyTorch's own kernels and
    memsets left out), by torch.profiler over the active step of its
    schedule, after two warm-up steps. The profiler drops some kernels of a
    trace, at its start and at times within it, and never adds any: so up
    to ``tries`` traces are taken until one holds each kernel exactly
    ``calls`` times, and a trace that holds another kernel of the port's,
    or one more than ``calls`` times, fails at once. ``counts`` are the
    last trace's (None where it saw no device event at all), ``traces``
    the traces taken."""
    counts = None
    for trace in range(1, tries + 1):
        schedule = torch.profiler.schedule(wait=0, warmup=2, active=1, repeat=1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA],
                                    schedule=schedule, acc_events=True) as prof:
            for step in range(3):
                for _ in range(calls if step == 2 else 1):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if not names:
            counts = None
            continue
        ours = [re.sub(r"^void |\(anonymous namespace\)::", "", n).split("(")[0]
                for n in names
                if any(k in n for k in ("extract_kernel", "init_keys_kernel", "plane_gather"))]
        counts = dict(collections.Counter(ours))
        by_name = collections.Counter(n.split("<")[0] for n in ours)
        if (any(n not in want for n in by_name)
                or any(c > calls for c in counts.values())
                or len(counts) > len(want)):
            return False, counts, trace
        if (sorted(n.split("<")[0] for n in counts) == sorted(want)
                and all(c == calls for c in counts.values())):
            return True, counts, trace
    return False, counts, tries


def launched_text(counts, traces, calls=8):
    """``port_kernels``'s counts as text."""
    if counts is None:
        return f"the profiler saw no device event ({traces} traces)"
    return (f"{len(counts)} kernels of the port's a call (over {calls} calls: "
            + ", ".join(f"{n} x{c}" for n, c in sorted(counts.items()))
            + f"; trace {traces})")


def make_waterfalls(rng):
    """8 complex64 waterfalls: |noise| ~ 1 +- 0.1, RFI of 1e6..1e7 (the
    synthetic generator's mJy scale) in channel stripes, time bursts and
    blocks, random phase. Returns (waterfalls, mask)."""
    shape = (N_WATERFALLS, SIDE, SIDE)
    amp = 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
    mask = np.zeros(shape, bool)
    for m in range(N_WATERFALLS):
        for _ in range(3):  # narrowband, persistent
            c = rng.integers(0, SIDE - 4)
            mask[m, c:c + rng.integers(1, 4)] = True
        for _ in range(2):  # broadband burst
            t = rng.integers(0, SIDE - 6)
            mask[m, :, t:t + rng.integers(1, 6)] = True
        for _ in range(2):  # block
            c, t = rng.integers(0, SIDE - 64, 2)
            mask[m, c:c + rng.integers(8, 64), t:t + rng.integers(8, 64)] = True
    rfi = rng.uniform(1e6, 1e7, shape).astype(np.float32)
    amp = np.where(mask, amp + rfi, amp)
    phase = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    return (amp * np.exp(1j * phase)).astype(np.complex64), mask


def order_key_to_float(keys):
    """float32 values of K5's order-preserving uint32 keys (int64 here)."""
    bits = np.where(keys >= 2 ** 31, keys & 0x7FFFFFFF, ~keys & 0xFFFFFFFF)
    return bits.astype(np.uint32).view(np.float32)


def k5_select_cases(patches, real, g):
    """Inputs that stress K5's 8-bit radix select: equal keys (quantised
    values, constant patches, +-0.0), middle pairs whose keys first differ
    at each of the 4 digits (even counts, so both ranks are selected), odd
    counts, and a ragged patch size (keys past the patch)."""
    dev = patches.device
    amp = patches[:64].abs()
    quantised = torch.round(amp * 4) / 4  # a few levels, and the RFI
    constant = torch.full((8, PATCH, PATCH), 1.25, device=dev)
    constant[1, 7, 7] = 40.0  # MAD 0: everything off the median is flagged
    constant[2, :, :3] = 40.0
    signs = torch.where(torch.rand((8, PATCH, PATCH), generator=g) < 0.5, -1.0, 1.0)
    zeros = (signs * 0.0).to(dev)  # +0.0 and -0.0
    zeros[:, :5] = signs[:, :5].to(dev) * 1e-3
    zeros[1, 3, 3] = 7.0
    # middle pairs: lo and hi = lo + 1 in key order, lo's low bits all ones
    # up to a digit, so the two first differ at that digit; the last pair,
    # -0.0 and +0.0, differs at the top digit
    pairs = [0xBEFFFFFF, 0xBF80FFFF, 0xBF8000FF, 0xBF800000, 0x7FFFFFFF]
    straddle = torch.empty((len(pairs), PATCH, PATCH))
    half = PATCH * PATCH // 2
    for i, lo in enumerate(pairs):
        mid = order_key_to_float(np.array([lo, lo + 1], np.int64))
        low = -3.0 - torch.rand(half - 1, generator=g)
        high = 3.0 + torch.rand(half - 1, generator=g)
        vals = torch.cat([low, torch.from_numpy(mid), high])
        straddle[i] = vals[torch.randperm(vals.numel(), generator=g)].reshape(PATCH, PATCH)
    odd = real[:4].clone()
    odd[:, 0, 0] = float("nan")  # 16383 valid pixels: one middle rank
    ragged = patches[:16, :37, :29].contiguous()
    return {"quantised": quantised, "constant": constant, "+-0.0": zeros,
            "straddle": straddle.to(dev), "odd count": odd, "37x29": ragged}


def cuda_ms(fn, calls=50, windows=5):
    """Milliseconds per call of ``fn`` on the card: ``calls`` calls back to
    back between one pair of CUDA events, with a few calls queued ahead of
    the start event so that the host's share of a call hides behind the
    card's work; the median over ``windows`` such windows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            fn()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def calls_per_s(fn):
    """Calls of ``fn`` per second: each of ``WINDOWS`` windows queues calls
    until ``WINDOW_S`` host seconds have passed, then waits for the card.
    Returns (median rate, lowest, highest, calls in all, result of the last
    call)."""
    rates, n_all = [], 0
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < WINDOW_S:
            out = fn()
            n += 1
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
        n_all += n
    return statistics.median(rates), min(rates), max(rates), n_all, out


def rate_text(rate, lo, hi):
    return f"{rate:.4g} (windows {lo:.4g}-{hi:.4g})"


def stats_agree(card, cpu, what):
    """Card and CPU statistics dicts: medians and MADs (and the MAD
    reduction, their ratio) bit-equal, the rest within STAT_RTOL or
    STAT_ATOL."""
    for k, want in cpu.items():
        got = card[k]
        if isinstance(want, dict):
            stats_agree(got, want, f"{what} {k}")
        elif k in ("median", "mad", "mad_reduction", "count"):
            require(got == want, f"{what}: {k} {got!r} on the card, {want!r} on the CPU")
        else:
            require(abs(got - want) <= max(STAT_RTOL * abs(want), STAT_ATOL),
                    f"{what}: {k} {got!r} on the card, {want!r} on the CPU")


def host_ms(fn, repeats=3):
    """Median host milliseconds of ``fn()`` and the card's work it
    queued, over ``repeats`` calls."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def flag_column(ms):
    """The FLAG cells of every row of a FakeMS, stacked."""
    return np.stack([r["FLAG"] for r in ms.rows])


def measurement_set_phases(kind, phases):
    """Phases 22-23: the measurement-set path (FakeMS -> MSLoader ->
    inject -> flag_measurement_set -> FLAG write-back -> FFI /
    calcquality) on a VLA-sized scan, then BASELINE configs 5 and 1.
    Returns the K4 and K5 launches of the runs through the entry points."""
    from rfi_toolbox_tpu_torch.evaluation import (
        compute_calcquality,
        compute_ffi,
        compute_statistics,
        evaluate_segmentation,
    )
    from rfi_toolbox_tpu_torch.io import (
        MSLoader,
        flag_measurement_set,
        flag_waterfalls,
        flag_waterfalls_coherent,
        inject_synthetic_data,
        make_fake_ms,
    )
    from rfi_toolbox_tpu_torch.ops import fused_extract_channels, mad_flag_patches
    from rfi_toolbox_tpu_torch.preprocess.pipeline import magnitude
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor
    from rfi_toolbox_tpu_torch.synth import RFISimulator, make_sample_generator

    dev = torch.device("cuda")
    launches = {"K4": 0, "K5": 0}

    def zero_counts():
        fused_extract_channels.launches = 0
        mad_flag_patches.launches = 0

    def read_counts():
        got = {"K4": fused_extract_channels.launches, "K5": mad_flag_patches.launches}
        for k, v in got.items():
            launches[k] += v
        return got

    # -- 22: the measurement-set round trip, a VLA-sized scan ------------------------------
    t = time.perf_counter()
    n_ant, n_t = VLA_MS["num_antennas"], VLA_MS["num_times"]
    n_bl, n_pol = n_ant * (n_ant - 1) // 2, VLA_MS["num_pols"]
    n_chan = sum(VLA_MS["channels_per_spw"])
    n_vis = n_bl * n_pol * n_chan * n_t
    t0 = time.perf_counter()
    ms = make_fake_ms(**VLA_MS, seed=None)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = RFISimulator(time_bins=n_t, freq_bins=n_chan, seed=MS_SEED)
    tf, truth = sim.generate_rfi_device(n_bl, generator=torch.Generator(device=dev).manual_seed(MS_SEED))
    # the simulator's (n, 4, T, F) -> the MS's (baselines, pols, channels, times)
    vis = tf.transpose(-1, -2).cpu().numpy()
    truth = truth.transpose(-1, -2).contiguous()
    del tf
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inject_synthetic_data(ms, vis, output_ms_path=ms)  # in place, split across the SPWs
    inject_s = time.perf_counter() - t0
    log(f"phase 22: a VLA-sized scan in the FakeMS: {n_ant} antennas ({n_bl} baselines), "
        f"{n_pol} pols, SPWs {VLA_MS['channels_per_spw']} -> {n_chan} channels, {n_t} "
        f"integrations (uncut): {len(ms.rows)} rows, {n_vis / 1e6:.2f} M visibilities, "
        f"{n_vis * 16 / 1e9:.2f} GB of complex128 DATA; built in {build_s:.2f} s, simulated "
        f"on the card in {sim_s:.2f} s (masked share {float(truth.float().mean()):.4f}), "
        f"injected in {inject_s:.2f} s")

    loader = MSLoader(ms)
    t0 = time.perf_counter()
    data = loader.load()
    load_s = time.perf_counter() - t0
    require(data.shape == (n_bl, n_pol, n_chan, n_t) and np.array_equal(data, vis),
            "the loaded scan differs from the injected visibilities")
    t0 = time.perf_counter()
    c64 = data.astype(np.complex64)
    cast_s = time.perf_counter() - t0
    h2d = host_ms(lambda: torch.from_numpy(c64).to(dev), repeats=3)
    t0 = time.perf_counter()
    staging = torch.empty(c64.shape, dtype=torch.complex64, pin_memory=True)
    pin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.copyto(staging.numpy(), data, casting="same_kind")
    cast_pinned_s = time.perf_counter() - t0
    h2d_pinned = host_ms(lambda: staging.to(dev, non_blocking=True), repeats=3)
    x = torch.from_numpy(c64).to(dev)  # the reference input on the card
    require(torch.equal(x.cpu(), staging), "the pinned staging copy differs")
    del staging, vis
    planes = x.reshape(-1, n_chan, n_t)
    cpu_x = torch.from_numpy(c64[:MS_CPU_BASELINES])
    cpu_planes = cpu_x.reshape(-1, n_chan, n_t)
    log(f"  host: load {load_s:.2f} s, complex128 -> complex64 {cast_s:.3f} s; to the card: "
        f"pageable {h2d:.1f} ms ({c64.nbytes / h2d / 1e6:.2f} GB/s); a pinned staging buffer "
        f"{pin_s:.3f} s to allocate, the cast into it {cast_pinned_s:.3f} s, its copy "
        f"{h2d_pinned:.1f} ms ({c64.nbytes / h2d_pinned / 1e6:.2f} GB/s)")

    truth4 = truth[:, None].expand(n_bl, n_pol, n_chan, n_t)
    methods = (
        ("mad", None, None),
        ("model", CompiledPredictor.from_snapshot(SNAPSHOTS[0], batch_size=BATCH),
         CompiledPredictor.from_snapshot(SNAPSHOTS[0], batch_size=CPU_PREDICT_BATCH,
                                         device="cpu")),
        ("model8", CompiledPredictor.from_snapshot(MODEL8_SNAPSHOT, batch_size=BATCH),
         CompiledPredictor.from_snapshot(MODEL8_SNAPSHOT, batch_size=CPU_PREDICT_BATCH,
                                         device="cpu")),
    )
    written = {}
    cpu_stats = None
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    for method, pred, cpu_pred in methods:
        for r in ms.rows:  # reset the FLAG column in place: no copy of the scan
            r["FLAG"][...] = False
        timings = {}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = flag_measurement_set(ms, method=method, sigma=SIGMA, predictor=pred,
                                   timings=timings)
        wall = time.perf_counter() - t0
        counts = read_counts()
        got = loader.load_flags()
        written[method] = got
        # the card's flag_waterfalls on the loaded data, and the CPU on 8 baselines
        if method == "model8":
            ref = flag_waterfalls_coherent(x, pred)[:, None].expand_as(x)
            cpu = flag_waterfalls_coherent(cpu_x, cpu_pred, device="cpu")[:, None]
        else:
            ref = flag_waterfalls(planes, method=method, sigma=SIGMA, predictor=pred)
            cpu = flag_waterfalls(cpu_planes, method=method, sigma=SIGMA, predictor=cpu_pred,
                                  device="cpu")
        ref = ref.reshape(x.shape).cpu().numpy()
        cpu = cpu.reshape(MS_CPU_BASELINES, -1, n_chan, n_t).expand(
            MS_CPU_BASELINES, n_pol, n_chan, n_t).numpy()
        cpu_agree = float((got[:MS_CPU_BASELINES] == cpu).mean())
        m = evaluate_segmentation(torch.from_numpy(got).to(dev), truth4)
        split = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        log(f"  flag_measurement_set(method={method!r}): {wall:.2f} s, "
            f"{n_vis / wall / 1e6:.3f} Mvis/s on {kind}; split (s): {split}; launches "
            f"K4 {counts['K4']}, K5 {counts['K5']}; {res['baselines']} baselines, flagged "
            f"{res['flagged_fraction']:.4f}; IoU against the simulator's masks {m['iou']:.4f} "
            f"(P {m['precision']:.4f}, R {m['recall']:.4f}; no floor); the written column "
            f"equals the card's flag_waterfalls: {np.array_equal(got, ref)}; the CPU's on "
            f"{MS_CPU_BASELINES} baselines on {cpu_agree:.6f} of the pixels")
        require(res["baselines"] == n_bl and not res["failed"], f"{method}: baselines")
        require(np.array_equal(got, ref),
                f"{method}: the written FLAG column differs from flag_waterfalls on the card")
        if method == "mad":
            require(counts == {"K4": 0, "K5": 1}, "the MS's mad run did not launch K5 once")
            require(cpu_agree == 1.0, "mad: the card's flags differ from the CPU's (K5 vs plain)")
            plain = flag_waterfalls(planes, method="mad", sigma=SIGMA, use_pallas=False)
            require(np.array_equal(plain.reshape(x.shape).cpu().numpy(), got),
                    "use_pallas=False: the plain MAD flags differ from K5's")
            log("  use_pallas=False (the plain MAD on the card): flags equal K5's")

            def stats_on_cpu(flags=got):  # some minutes of CPU sorts, beside the model runs
                t0 = time.perf_counter()
                out = {"statistics": compute_statistics(data, flags, device="cpu"),
                       "ffi": compute_ffi(data, flags, device="cpu"),
                       "calcquality": compute_calcquality(data, flags, device="cpu")}
                return out, time.perf_counter() - t0

            cpu_stats = pool.submit(stats_on_cpu)
        else:
            require(cpu_agree >= MASK_AGREE, f"{method}: the card's flags differ from the CPU's")
            require(counts == {"K4": int(method == "model"), "K5": 0},
                    f"{method}: kernel launches {counts}")
    del ref, cpu, methods

    # the statistics of the mad run's flags, card against CPU
    flags = torch.from_numpy(written["mad"]).to(dev)
    card = {"statistics": compute_statistics(x, flags), "ffi": compute_ffi(x, flags),
            "calcquality": compute_calcquality(x, flags)}
    stat_ms = {"statistics": host_ms(lambda: compute_statistics(x, flags)),
               "ffi": host_ms(lambda: compute_ffi(x, flags)),
               "calcquality": host_ms(lambda: compute_calcquality(x, flags))}
    mag = magnitude(x).reshape(-1)
    sort_ms = cuda_ms(lambda: torch.sort(mag), calls=3, windows=3)
    del mag
    cpu, cpu_s = cpu_stats.result()
    pool.shutdown()
    for name in card:
        stats_agree(card[name], cpu[name], name)
    other = {k: compute_ffi(x, torch.from_numpy(v).to(dev))["ffi"]
             for k, v in written.items() if k != "mad"}
    st, ffi, cq = card["statistics"], card["ffi"], card["calcquality"]
    log(f"  statistics of the mad flags over {n_vis / 1e6:.1f} M entries on {kind}: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stat_ms.items())
        + f" (host clock; one torch.sort of the {n_vis / 1e6:.1f} M magnitudes {sort_ms:.2f} "
        f"ms); "
        f"median {st['median']:.6g}, MAD {st['mad']:.6g}, FFI {ffi['ffi']:.6f} (MAD "
        f"reduction {ffi['mad_reduction']:.6f}, std {ffi['std_reduction']:.6f}), calcquality "
        f"{cq['calcquality']:.6f}; the CPU ({cpu_s:.1f} s, beside the model runs) agrees (medians and MADs "
        f"bit-equal); FFI of the model flags {other['model']:.6f}, model8 "
        f"{other['model8']:.6f}")
    loader.close()
    del x, planes, flags, data, c64, written, ms, loader, truth, truth4
    phases["MS round trip"] = time.perf_counter() - t

    # -- 23: BASELINE configs 5 and 1 at their own sizes -------------------------------------
    t = time.perf_counter()
    base = make_fake_ms(**CONFIG5_MS)
    nrows, nchan5 = CONFIG5_MS["num_times"], CONFIG5_MS["channels_per_spw"][0]
    n_bl5 = CONFIG5_MS["num_antennas"] * (CONFIG5_MS["num_antennas"] - 1) // 2
    n5 = n_bl5 * 4 * nchan5 * nrows
    flag_measurement_set(base.copy(), method="mad", sigma=SIGMA)  # warm-up, as bench.py
    runs = {}
    for mode in ("bulk", "streaming"):
        ms = base.copy()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = flag_measurement_set(ms, method="mad", sigma=SIGMA, streaming=mode == "streaming")
        runs[mode] = (ms, res, time.perf_counter() - t0, read_counts()["K5"])
    (bulk, rb, sb, kb), (stream, rs, ss, ks) = runs["bulk"], runs["streaming"]
    require(np.array_equal(flag_column(bulk), flag_column(stream)),
            "config 5: bulk and streaming wrote different flags")
    require(rb["baselines"] == rs["baselines"] == n_bl5 and kb == 1 and ks == n_bl5,
            "config 5: baselines or K5 launches")
    # flags set beforehand survive merge_existing
    merged = base.copy()
    pre = np.zeros((4, nchan5, nrows), bool)
    pre[:, ::7, ::5] = True
    MSLoader(merged).save_baseline_flags(0, 1, pre)
    zero_counts()
    flag_measurement_set(merged, method="mad", sigma=SIGMA, merge_existing=True)
    k_merge = read_counts()["K5"]
    want = flag_column(bulk)
    want[:nrows] |= np.moveaxis(pre, -1, 0)  # baseline (0, 1) holds the first rows
    require(np.array_equal(flag_column(merged), want), "config 5: merge_existing lost flags")
    # a ragged observation: baseline (0, 1) loses its last 32 integrations
    ragged = base.copy()
    ragged.rows = [r for r in ragged.rows if not (
        r["ANTENNA1"] == 0 and r["ANTENNA2"] == 1 and r["TIME"] >= 5e9 + nrows - 32)]
    zero_counts()
    rr = flag_measurement_set(ragged, method="mad", sigma=SIGMA)
    k_ragged = read_counts()["K5"]
    ld = MSLoader(ragged)
    short = flag_waterfalls(ld.load_baseline(0, 1), method="mad", sigma=SIGMA)
    require(rr["baselines"] == n_bl5 and not rr["failed"] and k_ragged == n_bl5
            and np.array_equal(ld.load_baseline_flags(0, 1), short.cpu().numpy())
            and np.array_equal(flag_column(ragged)[nrows - 32:], flag_column(bulk)[nrows:]),
            "config 5: the ragged MS was not flagged baseline by baseline")
    log(f"phase 23: config 5 ({CONFIG5_MS['num_antennas']} antennas, {nchan5} channels x "
        f"{nrows} integrations, 4 pols: {n5 / 1e6:.2f} M visibilities) "
        f"on {kind}: bulk {sb:.3f} s, {n5 / sb / 1e6:.3f} Mvis/s (K5 {kb}); streaming "
        f"{ss:.3f} s, {n5 / ss / 1e6:.3f} Mvis/s (K5 {ks}); flags bit-equal, flagged "
        f"{rb['flagged_fraction']:.5f}; merge_existing keeps the flags set before (K5 "
        f"{k_merge}); a ragged MS (baseline (0, 1) short by 32 integrations) takes the "
        f"streaming path: {rr['baselines']} baselines, K5 {k_ragged}")

    sample_fn = make_sample_generator(SIDE, SIDE, rfi_config=CONFIG1_EVENTS,
                                      num_polarizations=1)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def config1():
        wf = sample_fn(CONFIG1_B, g)[0][:, 0]
        return compute_ffi(wf, flag_waterfalls(wf, method="mad", sigma=SIGMA))

    config1()  # warm-up
    zero_counts()
    rate, lo, hi, calls, out = calls_per_s(config1)
    k_c1 = read_counts()["K5"]
    require(k_c1 == calls and np.isfinite(out["ffi"]), "config 1: K5 launches or FFI")
    log(f"  config 1 (make_sample_generator B={CONFIG1_B} x {SIDE}^2, one pol -> "
        f"flag_waterfalls mad -> compute_ffi) on {kind}: waterfalls/s "
        f"{rate_text(CONFIG1_B * rate, CONFIG1_B * lo, CONFIG1_B * hi)} in {calls} calls; "
        f"K5 {k_c1}; last FFI {out['ffi']:.4f}")
    phases["configs 5 and 1"] = time.perf_counter() - t
    return launches


def cli_phases(kind, phases):
    """Phase 24: the command-line path. Each command's ``main(argv)`` runs
    in this process, as a user's ``python -m rfi_toolbox_tpu_torch.cli...``
    would, in ``CLI_ROOT`` (removed at the end): generate -> normalize ->
    train -> evaluate, the instance and coherent recipes with a resume,
    ``--mesh_shape`` refused, and visualize's predictor. Returns K4's
    launches in the commands' runs (the direct calls they are held to are
    not counted)."""
    import contextlib
    import importlib.util
    import io
    import logging

    from rfi_toolbox_tpu_torch.cli import evaluate_model as cli_eval
    from rfi_toolbox_tpu_torch.cli import generate_dataset as cli_gen
    from rfi_toolbox_tpu_torch.cli import normalize_data as cli_norm
    from rfi_toolbox_tpu_torch.cli import train_model as cli_train
    from rfi_toolbox_tpu_torch.data import RFIMaskDataset
    from rfi_toolbox_tpu_torch.evaluation import evaluate_instance_model
    from rfi_toolbox_tpu_torch.models import create_model, load_params
    from rfi_toolbox_tpu_torch.ops import fused_extract_channels
    from rfi_toolbox_tpu_torch.synth import RFISimulator
    from rfi_toolbox_tpu_torch.train import CoherentTrainer, InstanceTrainer, Trainer
    from rfi_toolbox_tpu_torch.visualization import visualize

    dev = torch.device("cuda")
    # the commands' INFO lines stay out of this output: their basicConfig is a
    # no-op once the root logger has a handler
    logging.basicConfig(level=logging.WARNING)
    quiet = contextlib.redirect_stdout(io.StringIO())  # the evaluate command's printout
    root = CLI_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    launches = {"K4": 0}

    def k4_of(fn):
        fused_extract_channels.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = fused_extract_channels.launches
        launches["K4"] += n
        return out, n

    def spy(cls, name, note):
        """Wrap ``cls.name`` to call ``note(args, result)``; returns the undo."""
        original = getattr(cls, name)

        def wrapped(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            note(args, out)
            return out

        setattr(cls, name, wrapped)
        return lambda: setattr(cls, name, original)

    def restores(cls):
        seen = []
        return seen, spy(cls, "restore_checkpoint",
                         lambda args, step: seen.append((Path(args[0]).name, step)))

    try:
        # -- (a) generate_rfi_dataset at the command's published widths ---------------------
        t = time.perf_counter()
        data = root / "data"
        n_train, n_val = CLI_SAMPLES
        writes = [0.0]
        save = cli_gen.save_example_pair_npy

        def timed_save(*args, **kwargs):
            t0 = time.perf_counter()
            save(*args, **kwargs)
            writes[0] += time.perf_counter() - t0

        cli_gen.save_example_pair_npy = timed_save
        try:
            cli_gen.main(["--samples_training", str(n_train), "--samples_validation", str(n_val),
                          "--time_bins", str(CLI_SIDE), "--frequency_bins", str(CLI_SIDE),
                          "--seed", str(CLI_SEED), "--batch_size", str(CLI_GEN_BATCH),
                          "--output_dir", str(data)])
        finally:
            cli_gen.save_example_pair_npy = save
        gen_s = time.perf_counter() - t
        want = [f"{split}/{i:04d}/{f}" for split, n in (("train", n_train), ("val", n_val))
                for i in range(n) for f in ("input.npy", "rfi_mask.npy")]
        got = sorted(str(p.relative_to(data)) for p in data.rglob("*") if p.is_file())
        require(got == sorted(want), f"generate: file tree {got[:4]}... is not {want[:4]}...")
        n_bytes = 0
        for rel in want:
            a = np.load(data / rel, mmap_mode="r")
            n_bytes += a.nbytes
            shape = (8, CLI_SIDE, CLI_SIDE) if rel.endswith("input.npy") else (CLI_SIDE, CLI_SIDE)
            dtype = np.float32 if rel.endswith("input.npy") else np.bool_
            require(a.shape == shape and a.dtype == dtype, f"generate: {rel} {a.shape} {a.dtype}")
        sim = RFISimulator(CLI_SIDE, CLI_SIDE, seed=CLI_SEED, device=dev)
        tf, masks = sim.generate_rfi_device(
            CLI_GEN_BATCH, torch.Generator(device=dev).manual_seed(CLI_SEED))
        direct = torch.view_as_real(tf[0]).permute(0, 3, 1, 2).reshape(8, CLI_SIDE, CLI_SIDE)
        x0 = np.load(data / "train/0000/input.npy")
        m0 = np.load(data / "train/0000/rfi_mask.npy")
        same = np.array_equal(x0, direct.cpu().numpy()) and np.array_equal(
            m0, masks[0].cpu().numpy())
        require(same, "generate: sample 0 differs from generate_rfi_device with the same "
                f"generator (max diff {np.abs(x0 - direct.cpu().numpy()).max():.3g})")
        require(np.isfinite(x0).all() and 0 < m0.mean() < 1, "generate: sample 0's planes or mask")
        del tf, masks, direct, x0
        n = n_train + n_val
        log(f"phase 24: the command-line path on {kind}. (a) generate_rfi_dataset "
            f"{n_train} + {n_val} samples of {CLI_SIDE}^2 (batches of {CLI_GEN_BATCH}): "
            f"{gen_s:.3f} s, {gen_s / n:.4f} s a sample (the card's render and copy to the "
            f"host {(gen_s - writes[0]) / n:.4f}, the stacks and np.save writes "
            f"{writes[0] / n:.4f}); {n_bytes / 1e9:.3f} GB in {len(want)} files, the tree, "
            f"shapes and dtypes as the JAX command's; sample 0 bit-equal to "
            f"generate_rfi_device with the same generator (mask share {m0.mean():.4f})")

        # -- (b) normalize_rfi_data --------------------------------------------------------
        t = time.perf_counter()
        val, val_norm = data / "val", root / "val_norm"
        with quiet:
            cli_norm.main(["--input_dir", str(val), "--output_dir", str(val_norm),
                           "--normalization", "robust_scale"])
        norm_s = time.perf_counter() - t
        for i in range(n_val):
            d = f"{i:04d}"
            want_x = cli_norm.normalize_array(np.load(val / d / "input.npy"), "robust_scale")
            require(np.array_equal(np.load(val_norm / d / "input.npy"), want_x),
                    f"normalize: {d} differs from normalize_array")
            require(np.array_equal(np.load(val_norm / d / "rfi_mask.npy"),
                                   np.load(val / d / "rfi_mask.npy")), f"normalize: {d}'s mask")
        log(f"  (b) normalize_rfi_data robust_scale on the {n_val} validation samples: "
            f"{norm_s:.3f} s; each file equal to normalize_array on the host")

        # -- (c) train_rfi_model: the UNet at unet_default.yaml's width -------------------
        t = time.perf_counter()
        ck = root / "ck"
        semantic = ["--config", "configs/training/unet_default.yaml", "--batch_size",
                    str(CLI_TRAIN_BATCH), "--train_dir", str(data / "train"), "--val_dir",
                    str(val), "--checkpoint_dir", str(ck)]
        built = []
        create = cli_train.create_model

        def recording_create(*args, **kwargs):
            built.append(create(*args, **kwargs))
            return built[-1]

        cli_train.create_model = recording_create
        try:
            r1 = cli_train.main(semantic + ["--num_epochs", str(CLI_EPOCHS)])
            r2 = cli_train.main(semantic + ["--num_epochs", str(CLI_EPOCHS + 1),
                                            "--checkpoint_path", r1["final_checkpoint"]])
        finally:
            cli_train.create_model = create
        train_s = time.perf_counter() - t
        model = built[0]
        require(next(model.parameters()).device.type == "cuda" and model.in_channels == 8
                and model.init_features == 32 and model.dtype == torch.bfloat16,
                "train: the model is not UNet32 bf16 on the card with 8 input channels")
        require([h["epoch"] for h in r1["history"]] == list(range(1, CLI_EPOCHS + 1))
                and [h["epoch"] for h in r2["history"]] == [CLI_EPOCHS + 1],
                f"train: epochs {[h['epoch'] for h in r1['history']]} then "
                f"{[h['epoch'] for h in r2['history']]}")
        hist = r1["history"] + r2["history"]
        require(all(np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in hist),
                "train: a loss is not finite")
        log(f"  (c) train_rfi_model --config unet_default.yaml --batch_size {CLI_TRAIN_BATCH}: "
            f"UNet32 bf16 on the card, in_channels 8, {n_train} images of {CLI_SIDE}^2 an "
            f"epoch; s an epoch " + ", ".join(f"{h['seconds']:.3f}" for h in hist)
            + " (images/s " + ", ".join(f"{n_train / h['seconds']:.2f}" for h in hist)
            + "), the first with cuDNN's first calls; losses " + ", ".join(
                f"{h['train_loss']:.4f}/{h['val_loss']:.4f}" for h in hist)
            + f"; --checkpoint_path resumed at epoch {CLI_EPOCHS + 1}; {train_s:.3f} s in all")
        del built, model

        # -- (d) evaluate_rfi_model ---------------------------------------------------------
        t = time.perf_counter()
        final = r2["final_checkpoint"]
        with quiet:
            e_plain = cli_eval.main(["--model_path", final, "--dataset_dir", str(val),
                                     "--batch_size", str(n_val)])
            e_tta = cli_eval.main(["--model_path", final, "--dataset_dir", str(val),
                                   "--batch_size", str(n_val), "--tta"])
        for m in (e_plain, e_tta):
            require(set(m) == {"iou", "precision", "recall", "f1", "dice"}
                    and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
                    f"evaluate: metrics {m}")
        two = root / "val2"
        for i in range(CLI_EVAL_SAMPLES):
            shutil.copytree(val_norm / f"{i:04d}", two / f"{i:04d}")
        snap_args = ["--model_path", CLI_EVAL_SNAPSHOT, "--dataset_dir", str(two),
                     "--batch_size", str(CLI_EVAL_SAMPLES)]
        with quiet:
            card = cli_eval.main(snap_args)
            t_cpu = time.perf_counter()
            cpu = cli_eval.main(snap_args + ["--device", "cpu"])
            t_cpu = time.perf_counter() - t_cpu
        gap = max(abs(card[k] - cpu[k]) for k in card)
        require(gap <= CLI_DEVICE_TOL, f"evaluate: card {card} vs CPU {cpu}")
        log(f"  (d) evaluate_rfi_model on (c)'s checkpoint ({n_val} images): iou "
            f"{e_plain['iou']:.4f}, TTA {e_tta['iou']:.4f}; {CLI_EVAL_SNAPSHOT} on "
            f"{CLI_EVAL_SAMPLES} normalized samples: iou {card['iou']:.6f}, card vs CPU "
            f"(TF32 off) max metric gap {gap:.2e} (tolerance {CLI_DEVICE_TOL:g}; the CPU "
            f"{t_cpu:.2f} s); {time.perf_counter() - t:.3f} s")

        # -- (e) --instance: train, resume, export, evaluate (K4 a step and a batch) -------
        t = time.perf_counter()
        inst_ck, x_npz = root / "inst_ck", root / "x.npz"
        inst = ["--instance", "--checkpoint_every", str(CLI_CKPT), "--fused_steps",
                str(CLI_CKPT), "--eval_images", str(CLI_EVAL_IMAGES), "--export", str(x_npz),
                "--checkpoint_dir", str(inst_ck)]
        torch.backends.cudnn.deterministic = True
        try:
            ri, k_first = k4_of(lambda: cli_train.main(inst + ["--num_steps", str(CLI_STEPS)]))
            t_first = time.perf_counter() - t
            seen, unspy = restores(InstanceTrainer)
            try:
                t0 = time.perf_counter()
                ri2, k_resume = k4_of(lambda: cli_train.main(
                    inst + ["--num_steps", str(CLI_STEPS_RESUMED), "--auto_resume"]))
                t_resume = time.perf_counter() - t0
            finally:
                unspy()
            files = sorted(p.name for p in inst_ck.iterdir())
            require(files == [f"step_{s}.pt" for s in (CLI_CKPT, CLI_STEPS, CLI_STEPS_RESUMED)],
                    f"instance: checkpoints {files}")
            require(seen == [(f"step_{CLI_STEPS}.pt", CLI_STEPS)] and ri["steps"] == CLI_STEPS
                    and ri2["steps"] == CLI_STEPS_RESUMED,
                    f"instance: resumed from {seen}, steps {ri['steps']}, {ri2['steps']}")
            n_resumed = CLI_STEPS_RESUMED - CLI_STEPS
            require(k_first == CLI_STEPS + 1 and k_resume == n_resumed + 1,
                    f"instance: K4 launched {k_first} and {k_resume} times, not once a step "
                    "and once an evaluation batch")
            require(all(np.isfinite(h["loss"]) for h in ri["history"] + ri2["history"]),
                    "instance: a loss is not finite")
            rows = []
            all_six = cli_train._load_event_config(ALL_SIX_YAML)
            for path, argv, batch, score, mix in (
                    (x_npz, ["--batch_size", str(CLI_EVAL_IMAGES)], CLI_EVAL_IMAGES, 0.3, {}),
                    (SOLOLITE, ["--score_thresh", "0.25", "--event_config", ALL_SIX_YAML], 8,
                     0.25, {"rfi_config": all_six})):
                with quiet:
                    got, k_eval = k4_of(lambda: cli_eval.main(
                        ["--model_path", str(path), "--instance", "--num_images",
                         str(CLI_EVAL_IMAGES)] + argv))
                # the direct call the command is held to (its launches are not counted)
                want_q = evaluate_instance_model(
                    InstanceTrainer.load(path, batch_size=batch, **mix),
                    num_images=CLI_EVAL_IMAGES, seed=10_000, iou_thresh=0.5, score_thresh=score)
                require(got == want_q, f"instance: evaluate_rfi_model on {path} gave {got}, "
                        f"the direct call {want_q}")
                require(k_eval == -(-CLI_EVAL_IMAGES // batch),
                        f"instance: K4 launched {k_eval} times in evaluating {path}")
                rows.append(f"{Path(path).name} recall {got['recall']:.4f} precision "
                            f"{got['precision']:.4f} (K4 {k_eval})")
        finally:
            torch.backends.cudnn.deterministic = False
        steps_s = [h["steps_per_sec"] for h in ri["history"] + ri2["history"]]
        log(f"  (e) --instance (f=48, patch 128, batch 64): {CLI_STEPS} steps {t_first:.3f} s "
            f"with its evaluation and export, then --auto_resume from step_{CLI_STEPS}.pt to "
            f"{CLI_STEPS_RESUMED} in {t_resume:.3f} s; steps/s by fit call "
            + ", ".join(f"{s:.2f}" for s in steps_s)
            + f"; K4 {k_first} + {k_resume} (once a step and an evaluation batch); "
            "evaluate_rfi_model --instance equal to the direct calls: " + "; ".join(rows))

        # -- (f) --coherent: train, resume, export, evaluate --------------------------------
        t = time.perf_counter()
        coh_ck, y_npz = root / "coh_ck", root / "y.npz"
        coh = ["--coherent", "--checkpoint_every", str(CLI_CKPT), "--export", str(y_npz),
               "--checkpoint_dir", str(coh_ck)]
        rates = []  # each fit call's steps/s (its one log record, at its end)
        unfit = spy(CoherentTrainer, "fit",
                    lambda args, out: rates.append(out["history"][-1]["steps_per_sec"]))
        try:
            rc, k_coh = k4_of(lambda: cli_train.main(coh + ["--num_steps", str(CLI_STEPS)]))
            t_first = time.perf_counter() - t
            seen, unspy = restores(CoherentTrainer)
            try:
                rc2, k_coh2 = k4_of(lambda: cli_train.main(
                    coh + ["--num_steps", str(CLI_STEPS_RESUMED), "--auto_resume"]))
            finally:
                unspy()
        finally:
            unfit()
        files = sorted(p.name for p in coh_ck.iterdir())
        require(files == [f"step_{s}.pt" for s in (CLI_CKPT, CLI_STEPS, CLI_STEPS_RESUMED)],
                f"coherent: checkpoints {files}")
        require(seen == [(f"step_{CLI_STEPS}.pt", CLI_STEPS)] and rc["steps"] == CLI_STEPS
                and rc2["steps"] == CLI_STEPS_RESUMED and k_coh == k_coh2 == 0,
                f"coherent: resumed from {seen}, steps {rc['steps']}, {rc2['steps']}, "
                f"K4 {k_coh} {k_coh2}")
        meta = load_params(y_npz)[2]
        require(meta["steps"] == CLI_STEPS_RESUMED and meta["in_channels"] == 8,
                f"coherent: the exported metadata {meta}")
        with quiet:
            ey = cli_eval.main(["--model_path", str(y_npz), "--coherent"])
            gate_t = load_params(CLI_COHERENT_SNAPSHOT)[2]["best_threshold"]
            eg = cli_eval.main(["--model_path", CLI_COHERENT_SNAPSHOT, "--coherent",
                                "--num_images", str(GATE_BATCHES * GATE_BATCH),
                                "--batch_size", str(GATE_BATCH), "--threshold", str(gate_t)])
        floor = COHERENT_GATES[Path(CLI_COHERENT_SNAPSHOT).stem][0]
        require(eg["best_iou"] >= floor, f"coherent: {CLI_COHERENT_SNAPSHOT} held-out IoU "
                f"{eg['best_iou']:.4f} under phase 17(a)'s floor {floor}")
        log(f"  (f) --coherent (UNet24, 256^2, batch 16, bf16): {CLI_STEPS} steps {t_first:.3f} "
            f"s with its sweep and export, resumed from step_{CLI_STEPS}.pt to "
            f"{CLI_STEPS_RESUMED}; steps/s by fit call " + ", ".join(f"{r:.2f}" for r in rates)
            + f"; held-out best IoU {rc['eval']['best_iou']:.4f} then "
            f"{rc2['eval']['best_iou']:.4f}; evaluate_rfi_model --coherent on the export "
            f"{ey['best_iou']:.4f} @ {ey['best_threshold']} (32 samples); on "
            f"{Path(CLI_COHERENT_SNAPSHOT).name} at its threshold {gate_t} over phase 17(a)'s "
            f"{GATE_BATCHES} x {GATE_BATCH} samples: mean IoU a sample {eg['best_iou']:.4f} "
            f"(phase 17(a)'s floor {floor}, there a batch's pooled IoU); "
            f"{time.perf_counter() - t:.3f} s")

        # -- (g) --mesh_shape beyond one device ---------------------------------------------
        refused = []
        for argv in (semantic + ["--mesh_shape", "2,1"], coh + ["--mesh_shape", "2,1"]):
            try:
                cli_train.main(argv)
            except SystemExit as e:
                refused.append(str(e))
        require(len(refused) == 2 and all("asks for 2 devices but this run has 1" in r
                                          for r in refused),
                f"mesh: --mesh_shape 2,1 not refused: {refused}")
        log(f"  (g) --mesh_shape 2,1 refused (semantic and --coherent): {refused[0]}")

        # -- (h) visualize_rfi_data's predictor ---------------------------------------------
        t = time.perf_counter()
        x, _ = RFIMaskDataset(str(val), device=dev)[0]
        x = x.cpu().numpy()
        got = visualize._predictor(final, 8, "unet", 32, (CLI_SIDE, CLI_SIDE, 8))(x)
        trainer = Trainer(create_model("unet", in_channels=8, init_features=32))
        trainer.restore(final)
        want_p = trainer.predict(np.transpose(x, (1, 2, 0))[None])[0].cpu().numpy()
        require(np.array_equal(got, want_p.astype(float)),
                "visualize: _predictor differs from Trainer.predict")
        drawing = [m for m in ("matplotlib", "bokeh") if importlib.util.find_spec(m)]
        log(f"  (h) visualize_rfi_data's _predictor on the card equals Trainer.predict on "
            f"validation sample 0 ({got.mean():.4f} flagged); {time.perf_counter() - t:.3f} s; "
            f"drawing not checked here ({', '.join(drawing) or 'neither matplotlib nor bokeh'}"
            f" installed; tests/test_torch_visualize.py draws on the CPU)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches

def parallel_phases(kind, wf):
    """Phase 25: the mesh paths at world size 1 on the card, through a real
    NCCL process group (see the module docstring). ``wf``: phase 5's
    waterfalls on the card. Returns K4's and K5's launches on the mesh
    paths (the meshless runs they are held to are not counted)."""
    import logging
    import socket

    import torch.distributed as dist

    from rfi_toolbox_tpu_torch.cli import train_model as cli_train
    from rfi_toolbox_tpu_torch.data import ArrayDataset, BatchWriter
    from rfi_toolbox_tpu_torch.io import flag_waterfalls
    from rfi_toolbox_tpu_torch.models import SOLOLite, create_model
    from rfi_toolbox_tpu_torch.ops import (
        fused_extract_channels,
        fused_extract_channels_plain,
        mad_flag_patches,
    )
    from rfi_toolbox_tpu_torch.parallel import initialize_distributed, make_mesh, process_info
    from rfi_toolbox_tpu_torch.parallel.spatial import preprocess_sharded, sharded_global_stats
    from rfi_toolbox_tpu_torch.preprocess import pipeline as P
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor
    from rfi_toolbox_tpu_torch.train import CoherentTrainer, InstanceTrainer, Trainer

    logging.basicConfig(level=logging.WARNING)
    launches = {"K4": 0, "K5": 0}

    def reset_counts():
        fused_extract_channels.launches = 0
        mad_flag_patches.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        k4, k5 = fused_extract_channels.launches, mad_flag_patches.launches
        launches["K4"] += k4
        launches["K5"] += k5
        return k4, k5

    def gaps(got, want, lr):
        """max |param diff| / lr and the share of coordinates within lr / 100"""
        diff = torch.cat([(a.double() - b.double()).abs().flatten() for a, b in zip(got, want)])
        return float(diff.max()) / lr, float((diff <= lr / 100).double().mean())

    def params_of(trainer):
        return [p.detach().clone() for p in trainer.state.params]

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t = time.perf_counter()
    multi = initialize_distributed(coordinator_address=f"localhost:{port}", num_processes=1,
                                   process_id=0)
    require(not multi and dist.is_initialized() and dist.get_backend() == "nccl",
            "mesh: the NCCL process group of one rank did not start")
    log(f"phase 25: the mesh paths at world size 1 on {kind}: process group "
        f"{dist.get_backend()}, (rank, world, local cards) {process_info()}, "
        f"{time.perf_counter() - t:.2f} s to start")
    root = Path("build/chip_smoke_mesh")
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        # -- (a) Trainer(mesh_shape=(1, 1)) against Trainer() --------------------------------
        t = time.perf_counter()
        g = torch.Generator().manual_seed(PAR_SEED)
        n = PAR_STEPS * PAR_BATCH
        images = torch.randn((n, PAR_SIDE, PAR_SIDE, PAR_MODEL["in_channels"]), generator=g)
        labels = (images[..., 0] > 1.2).to(torch.uint8)
        ds = ArrayDataset(images.numpy(), labels.numpy())
        torch.backends.cudnn.deterministic = True
        rates = {}
        for dtype in (torch.bfloat16, torch.float32):
            runs = {}
            for mesh_shape in (None, (1, 1)):
                trainer = Trainer(create_model(PAR_MODEL["model_type"],
                                               in_channels=PAR_MODEL["in_channels"],
                                               init_features=PAR_MODEL["init_features"],
                                               dtype=dtype),
                                  learning_rate=PAR_LR, mesh_shape=mesh_shape, seed=PAR_SEED)
                history = trainer.fit(ds, num_epochs=2, batch_size=PAR_BATCH)["history"]
                runs[mesh_shape] = (history, params_of(trainer))
                rates[(dtype, mesh_shape)] = PAR_STEPS / history[1]["seconds"]
                require(trainer.mesh is None or trainer.mesh.shape == {"data": 1, "model": 1},
                        "mesh: Trainer(mesh_shape=(1, 1)) built another mesh")
                del trainer
            (h_plain, p_plain), (h_mesh, p_mesh) = runs[None], runs[(1, 1)]
            loss_gap = max(abs(a["train_loss"] - b["train_loss"]) for a, b in zip(h_mesh, h_plain))
            worst, share = gaps(p_mesh, p_plain, PAR_LR)
            name = str(dtype).removeprefix("torch.")
            log(f"  (a) Trainer(mesh_shape=(1, 1)) against Trainer(), {PAR_MODEL['model_type']} "
                f"f={PAR_MODEL['init_features']}, {PAR_MODEL['in_channels']} channels, batch "
                f"{PAR_BATCH} at {PAR_SIDE}^2, {name}, 2 epochs of {PAR_STEPS} steps "
                f"(deterministic cuDNN): losses {[round(h['train_loss'], 6) for h in h_mesh]} "
                f"against {[round(h['train_loss'], 6) for h in h_plain]}, gap {loss_gap:.3g} "
                f"(tol 1e-5); parameters max |diff| {worst:.3g} * lr (tol 0.5), "
                f"{share:.6f} within lr / 100 (tol 0.99); steps/s of the second epoch "
                f"{rates[(dtype, (1, 1))]:.2f} with the mesh, {rates[(dtype, None)]:.2f} without")
            require(loss_gap <= 1e-5 and worst <= 0.5 and share >= 0.99,
                    f"mesh: Trainer(mesh_shape=(1, 1)) departs from Trainer() in {name}")
            del runs, p_plain, p_mesh
        torch.backends.cudnn.deterministic = False
        log(f"  (a) {time.perf_counter() - t:.2f} s")

        # -- (b) flag_waterfalls(mesh=): K5 and K4 ----------------------------------------
        t = time.perf_counter()
        mesh = make_mesh((1,), axis_names=("data",))
        pred = CompiledPredictor.from_snapshot(SNAPSHOTS[0], batch_size=BATCH)
        for name, x in (("8 waterfalls", wf), ("one waterfall", wf[:1])):
            plain_mad = flag_waterfalls(x, method="mad", sigma=SIGMA)
            k5_plain = flag_waterfalls(x, method="mad", sigma=SIGMA, use_pallas=False)
            plain_model = flag_waterfalls(x, method="model", predictor=pred)
            reset_counts()
            mesh_mad = flag_waterfalls(x, method="mad", sigma=SIGMA, mesh=mesh)
            mesh_model = flag_waterfalls(x, method="model", predictor=pred, mesh=mesh)
            k4, k5 = read_counts()
            mad_ms = cuda_ms(lambda: flag_waterfalls(x, method="mad", sigma=SIGMA, mesh=mesh),
                             calls=10, windows=3)
            mad_plain_ms = cuda_ms(lambda: flag_waterfalls(x, method="mad", sigma=SIGMA),
                                   calls=10, windows=3)
            log(f"  (b) flag_waterfalls(mesh=) on {name}: mad flags equal to the meshless "
                f"call's {torch.equal(mesh_mad, plain_mad)} and to K5's plain version's "
                f"{torch.equal(mesh_mad, k5_plain)} ({float(mesh_mad.float().mean()):.5f} "
                f"flagged); model flags equal {torch.equal(mesh_model, plain_model)}; K4 {k4}, "
                f"K5 {k5} launches; a mad call {mad_ms:.4f} ms with the mesh (its flags "
                f"gathered over NCCL), {mad_plain_ms:.4f} ms without")
            require(torch.equal(mesh_mad, plain_mad) and torch.equal(mesh_mad, k5_plain)
                    and torch.equal(mesh_model, plain_model),
                    f"mesh: flag_waterfalls(mesh=) differs from the meshless flags ({name})")
            require(k4 == 1 and k5 == 1, f"mesh: flag_waterfalls(mesh=) on {name} did not "
                    "launch K4 and K5 once each")
        del pred
        log(f"  (b) {time.perf_counter() - t:.2f} s (at one rank M = 1 is not below the data "
            "axis, so the channel split is not taken: the gloo tests hold it at 2 and 4)")

        # -- (c) preprocess_sharded (K4) and sharded_global_stats --------------------------
        t = time.perf_counter()
        reset_counts()
        img = preprocess_sharded(wf, mesh, patch_size=PATCH)
        k4, _ = read_counts()
        want = fused_extract_channels_plain(P.patchify_batch(wf, PATCH).contiguous())
        err = extract_err((img,), (want,), "preprocess_sharded")
        mag = wf.abs()
        t0 = time.perf_counter()
        stats = sharded_global_stats(mag, mesh)
        stats_s = time.perf_counter() - t0
        srt = torch.sort(mag.flatten()).values
        m = srt.numel()
        median = float(0.5 * (srt[(m - 1) // 2] + srt[m // 2]))
        mean64, std64 = float(mag.double().mean()), float(mag.double().std(correction=0))
        rel_mean = abs(stats["mean"] - mean64) / mean64
        rel_std = abs(stats["std"] - std64) / std64
        log(f"  (c) preprocess_sharded {tuple(img.shape)}: max |diff| to the plain extraction "
            f"{err:.2e} (tol {PAR_TOL:g}), K4 {k4} launch; sharded_global_stats of |z| over "
            f"{m} values in {stats_s:.3f} s: median {stats['median']!r}, a torch.sort's "
            f"middle pair {median!r}; mean and std off float64 by {rel_mean:.2e} and "
            f"{rel_std:.2e} (tol 1e-5, 1e-4); {time.perf_counter() - t:.2f} s")
        require(err <= PAR_TOL and k4 == 1, "mesh: preprocess_sharded departs from the plain "
                "extraction or did not launch K4 once")
        require(stats["median"] == median and rel_mean <= 1e-5 and rel_std <= 1e-4,
                "mesh: sharded_global_stats departs from the sorted values")
        del img, want, mag, srt

        # -- (d) CoherentTrainer(mesh=) and InstanceTrainer(mesh_shape=) ------------------
        t = time.perf_counter()
        torch.backends.cudnn.deterministic = True
        for name, make, lr in (
                ("CoherentTrainer", lambda m: CoherentTrainer(
                    **COHERENT_RECIPE, learning_rate=PAR_LR, seed=PAR_SEED, mesh=m), PAR_LR),
                ("InstanceTrainer", lambda m: InstanceTrainer(
                    model=SOLOLite(**INST_MODEL), patch_size=PATCH, batch_size=INST_BATCH,
                    learning_rate=INST_CHECK_LR, seed=PAR_SEED,
                    mesh_shape=None if m is None else (1,)), INST_CHECK_LR)):
            runs = {}
            for on_mesh in (False, True):
                trainer = make(mesh if on_mesh else None)
                reset_counts()
                history = trainer.fit(PAR_RECIPE_STEPS, log_every=1, fused_steps=1)["history"]
                k4, _ = read_counts() if on_mesh else (fused_extract_channels.launches, 0)
                runs[on_mesh] = ([h["loss"] for h in history], params_of(trainer), k4)
                del trainer
            (l_plain, p_plain, _), (l_mesh, p_mesh, k4) = runs[False], runs[True]
            loss_gap = max(abs(a - b) for a, b in zip(l_mesh, l_plain))
            worst, share = gaps(p_mesh, p_plain, lr)
            log(f"  (d) {name} on a data mesh of one against none, {PAR_RECIPE_STEPS} steps: "
                f"losses {[round(v, 6) for v in l_mesh]}, gap {loss_gap:.3g} (tol 1e-5); "
                f"parameters max |diff| {worst:.3g} * lr (tol 0.5), {share:.6f} within "
                f"lr / 100; K4 launches {k4}")
            require(loss_gap <= 1e-5 and worst <= 0.5 and share >= 0.99,
                    f"mesh: {name} on the mesh departs from the meshless run")
            require(name != "InstanceTrainer" or k4 == PAR_RECIPE_STEPS,
                    "mesh: InstanceTrainer did not launch K4 once a step")
            del runs, p_plain, p_mesh
        torch.backends.cudnn.deterministic = False
        log(f"  (d) {time.perf_counter() - t:.2f} s")

        # -- (e) train_rfi_model --config unet_dp_tp.yaml --mesh_shape 1,1 -------------------
        t = time.perf_counter()
        writer = BatchWriter(root / "batches", samples_per_batch=PAR_BATCH)
        writer.add_batch(ds)
        writer.finalize()
        argv = ["--config", "configs/training/unet_dp_tp.yaml", "--train_batches_dir",
                str(root / "batches"), "--num_epochs", "1", "--checkpoint_dir",
                str(root / "ck")]
        res = cli_train.main(argv + ["--mesh_shape", "1,1"])
        final = torch.load(res["final_checkpoint"], weights_only=True)
        restored = Trainer(create_model(PAR_MODEL["model_type"],
                                        in_channels=PAR_MODEL["in_channels"],
                                        init_features=PAR_MODEL["init_features"]))
        restored.restore(res["final_checkpoint"])
        try:
            cli_train.main(argv + ["--mesh_shape", "2,1"])
            refused = ""
        except SystemExit as e:
            refused = str(e)
        loss = res["history"][0]["train_loss"]
        log(f"  (e) train_rfi_model --config unet_dp_tp.yaml --mesh_shape 1,1, one epoch of "
            f"{final['step']} steps of {PAR_BATCH}: loss {loss:.6f}, final checkpoint restores "
            f"in a meshless Trainer; --mesh_shape 2,1 refused: {refused!r}; "
            f"{time.perf_counter() - t:.2f} s")
        require(np.isfinite(loss) and final["step"] == PAR_STEPS,
                "mesh: train_rfi_model --mesh_shape 1,1 did not train")
        require("asks for 2 devices but this run has 1" in refused,
                "mesh: --mesh_shape 2,1 was not refused at world size 1")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rfi_toolbox_tpu_torch import ops
    from rfi_toolbox_tpu_torch.data import ArrayDataset, BatchWriter, StreamingDataset
    from rfi_toolbox_tpu_torch.evaluation import evaluate_segmentation
    from rfi_toolbox_tpu_torch.evaluation import evaluate_segmentation_batch
    from rfi_toolbox_tpu_torch.evaluation import evaluate_instance_model
    from rfi_toolbox_tpu_torch.io import flag_waterfalls, flag_waterfalls_coherent
    from rfi_toolbox_tpu_torch.io.flagging import coherent_images
    from rfi_toolbox_tpu_torch.models import DoubleConv, SOLOLite, UNet, load_params
    from rfi_toolbox_tpu_torch.models import solo_decode, solo_loss
    from rfi_toolbox_tpu_torch.ops import (
        _lib,
        fused_extract_channels,
        fused_extract_channels_plain,
        mad_flag_patches,
        mad_flag_patches_plain,
    )
    from rfi_toolbox_tpu_torch.preprocess import DevicePreprocessor, Preprocessor
    from rfi_toolbox_tpu_torch.preprocess import pipeline as P
    from rfi_toolbox_tpu_torch.preprocess.static_prep import (
        make_static_prep_fn,
        transform_by_variant_nhwc,
    )
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor
    from rfi_toolbox_tpu_torch.synth import (
        RFISimulator,
        SyntheticDataGenerator,
        make_sample_generator,
    )
    from rfi_toolbox_tpu_torch.train import (
        CoherentTrainer,
        InstanceTrainer,
        RawPatchTrainer,
        coherent_batch,
        Trainer,
        bce_dice_loss,
        create_train_state,
        export_params,
        make_instance_train_step,
        train_step,
        train_steps,
        warmup_cosine_decay_schedule,
    )
    from rfi_toolbox_tpu_torch.train.coherent_trainer import robust_scale, to_8ch
    from rfi_toolbox_tpu_torch.train.flops import unet_train_flops_analytic
    from rfi_toolbox_tpu_torch.utils import set_tf32

    phases = {}
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"device: {kind} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_tf32(False)

    # -- build ------------------------------------------------------------
    t = time.perf_counter()
    lib = _lib.load()
    phases["build"] = time.perf_counter() - t
    log(f"build: nvcc {lib.build_seconds:.1f} s -> {lib.path.name}")
    kernel_report(lib, _lib._nvcc())

    # -- data ---------------------------------------------------------------
    t = time.perf_counter()
    rng = np.random.default_rng(SEED)
    wf_np, mask_np = make_waterfalls(rng)
    wf = torch.from_numpy(wf_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    patches = P.patchify_batch(wf, PATCH).contiguous()  # (512, 128, 128)
    n_patches = patches.shape[0]
    phases["data"] = time.perf_counter() - t

    # -- K4 -----------------------------------------------------------------
    t = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(SEED)
    real = (3.0 * torch.randn((16, PATCH, PATCH), generator=g)).to(dev)
    g4 = torch.Generator(device="cpu").manual_seed(SEED + 4)  # K4's hard cases
    k4_nan = patches[:64].clone()
    k4_nan[(torch.rand(k4_nan.shape, generator=g4) < 0.01).to(dev)] = complex(float("nan"), 0.0)
    k4_nan[5] = complex(float("nan"), 0.0)  # a patch of NaN only
    # a contiguous view one complex64 element (8 bytes) into a larger buffer
    shifted = torch.empty(37 * PATCH * PATCH + 1, dtype=torch.complex64, device=dev)
    shifted = shifted[1:].view(37, PATCH, PATCH)
    shifted.copy_(patches[100:137])
    require(shifted.is_contiguous() and shifted.data_ptr() % 16 == 8,
            "K4: the misaligned case is not 8 bytes off 16-byte alignment")
    cases = {
        "512x128^2": patches,
        "odd N=37": patches[100:137].contiguous(),
        "constant": torch.full((3, PATCH, PATCH), 2 + 1j, dtype=torch.complex64,
                               device=dev),
        "real f32": real,
        "NaN pixels": k4_nan,
        "3x5": patches[:16, :3, :5].contiguous(),
        "5x7": patches[:16, :5, :7].contiguous(),
        "33x128": patches[:16, :33].contiguous(),
        "128x127": patches[:16, :, :127].contiguous(),
        "8 B off 16 B": shifted,
    }
    k4_err = {}
    for name, x in cases.items():
        got, want = fused_extract_channels(x), fused_extract_channels_plain(x)
        torch.cuda.synchronize()
        k4_err[name] = extract_err((got,), (want,), f"K4 {name}")
    log("K4 max|kernel-plain|: " + ", ".join(
        f"{k} {v:.2e}" for k, v in k4_err.items()) + f" (tol {K4_TOL:g})")
    require(max(k4_err.values()) <= K4_TOL, "K4 disagrees with its plain version")
    k4_ms = cuda_ms(lambda: fused_extract_channels(patches))
    k4_plain_ms = cuda_ms(lambda: fused_extract_channels_plain(patches))
    px = patches.numel()
    k4_bound, k4_bound_by = bound(px * (8 + 12), px * K4_OPS_PER_PIXEL)
    log(f"K4 at (512,128,128) c64: kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, "
        f"bound {k4_bound:.4f} ms ({k4_bound_by}), {k4_ms / k4_bound:.1f}x the bound")

    # K4 above 128 x 128: the resident-group kernel where its slabs fit, else
    # the strip kernel (extract_route); every case also on both kernels
    # launched directly
    p256 = P.patchify_batch(wf, LARGE).contiguous()  # (128, 256, 256)
    nan256 = p256[:8].clone()
    nan256[(torch.rand(nan256.shape, generator=g4) < 0.01).to(dev)] = complex(float("nan"), 0.0)
    nan256[3] = complex(float("nan"), 0.0)  # a patch of NaN only
    shifted256 = torch.empty(8 * LARGE * LARGE + 1, dtype=torch.complex64, device=dev)
    shifted256 = shifted256[1:].view(8, LARGE, LARGE)
    shifted256.copy_(p256[8:16])
    wide = torch.cat([torch.cat([wf[0], wf[1]], 1), torch.cat([wf[2], wf[3]], 1)], 0)[None]
    large_cases = {
        "32x256^2": p256[:32],
        "512x256^2": p256.repeat(4, 1, 1),
        "8x1024^2": wf,
        "real 32x256^2": p256[:32].abs(),
        "real 8x1024^2": wf.abs(),
        "NaN pixels 256^2": nan256,
        "constant 256^2": torch.full((3, LARGE, LARGE), 2 + 1j, dtype=torch.complex64,
                                     device=dev),
        "129x130": wf[:, :129, :130].contiguous(),
        "1000x1024": wf[:2, :1000].contiguous(),
        "8 B off 16 B 256^2": shifted256,
        "1x2048^2": wide.contiguous(),  # 33.5 MB of complex64: the strip route
    }
    k4_group_err, k4_strip_err, k4_diff, cells = {}, {}, {}, []
    k4_wrap_err = {"groups": {}, "strips": {}}  # the wrapper's, by its route
    k4_wrap_diff = {}  # the wrapper's elements off the kernel its route names
    for name, x in large_cases.items():
        got, want = fused_extract_channels(x), fused_extract_channels_plain(x)
        rows, groups, strips = both_kernels("K4", x)
        torch.cuda.synchronize()
        route = route_of("K4", x)[0]
        err = k4_wrap_err[route][name] = extract_err((got,), (want,), f"K4 {name}")
        k4_wrap_diff[name] = differing((got,), groups if route == "groups" else strips)
        k4_strip_err[name] = extract_err(strips, (want,), f"K4 {name}, strip kernel")
        if groups is not None:
            k4_group_err[name] = extract_err(groups, (want,), f"K4 {name}, group kernel")
            k4_diff[name] = differing(groups, strips)
        cells.append(f"{name} [{route}] {err:.2e} ({k4_wrap_diff[name]} differing from the "
                     f"{route} kernel's), group kernel (rows {rows}) "
                     + (f"{k4_group_err[name]:.2e}, {k4_diff[name]} differing from the strip "
                        f"kernel's" if groups is not None else "none fits")
                     + f", strip kernel {k4_strip_err[name]:.2e}")
    del got, want, groups, strips
    log("K4 above 128^2, max|kernel-plain| of the wrapper by its route (and the elements it "
        "differs in from that kernel launched directly), of each kernel launched directly, "
        f"and the elements the two differ in: {'; '.join(cells)} (tol {K4_TOL:g}; "
        "differing must be 0)")
    require(max([*k4_wrap_err["groups"].values(), *k4_wrap_err["strips"].values(),
                 *k4_group_err.values(), *k4_strip_err.values()]) <= K4_TOL,
            "K4 above 128^2 disagrees with its plain version")
    require(not any(k4_wrap_diff.values()),
            "K4 above 128^2 differs from the kernel its route names")
    require(not any(k4_diff.values()), "K4's group kernel differs from its strip kernel")
    require(route_of("K4", large_cases["1x2048^2"])[0] == "strips"
            and route_of("K4", p256[:32])[0] == "groups",
            "K4: 2048^2 does not take the strip route or 256^2 the group route")
    k4_large = {}
    big = wf.repeat(16, 1, 1)  # (128, 1024, 1024): phase 14's generation batch
    for shape, x, calls in (("(32,256,256)", p256[:32], 50), ("(128,1024,1024)", big, 10)):
        n_px = x.numel()
        b_ms, b_by = bound(n_px * (8 + 12), n_px * K4_OPS_PER_PIXEL)
        route = route_of("K4", x)
        g_call, _, rows = direct_kernel("K4", "groups", x)
        s_call, _, _ = direct_kernel("K4", "strips", x)
        k_ms = cuda_ms(lambda: fused_extract_channels(x), calls=calls)
        group_ms = cuda_ms(g_call, calls=calls)
        strip_ms = cuda_ms(s_call, calls=calls)
        p_ms = cuda_ms(lambda: fused_extract_channels_plain(x), calls=3, windows=3)
        once, counts, traces = port_kernels(lambda: fused_extract_channels(x),
                                            route_kernels("K4", route[0]))
        k4_large[shape] = (k_ms, p_ms, b_ms, b_by)
        log(f"K4 at {shape} c64: route {route}, wrapper {k_ms:.4f} ms ("
            + launched_text(counts, traces)
            + f"); resident-group kernel (rows {rows}) {group_ms:.4f} ms, strip kernel "
            f"{strip_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), wrapper "
            f"{k_ms / b_ms:.1f}x the bound")
        require(once, f"K4 at {shape}: not the {route[0]} route's kernels once a call")
    del big, g_call, s_call
    phases["K4"] = time.perf_counter() - t

    # -- K5 -----------------------------------------------------------------
    t = time.perf_counter()
    with_nan = patches[:64].clone()
    nan_at = torch.rand(with_nan.shape, generator=g).to(dev) < 0.01
    with_nan[nan_at] = complex(float("nan"), 0.0)
    with_nan[5] = complex(float("nan"), 0.0)  # an all-NaN patch
    negative = real.clone()
    negative[:, :4] -= 50.0
    cases = {
        "512x128^2": patches,
        "whole 1024^2": wf,
        "NaNs": with_nan,
        "negative real": negative,
        **k5_select_cases(patches, real, g),
    }
    k5_diff = {}
    for name, x in cases.items():
        got, want = mad_flag_patches(x, SIGMA), mad_flag_patches_plain(x, SIGMA)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == torch.bool,
                f"K5 {name}: shape or dtype")
        k5_diff[name] = int((got != want).sum())
    log("K5 flags differing from plain: " + ", ".join(
        f"{k} {v}" for k, v in k5_diff.items()) + " (must be 0)")
    require(not any(k5_diff.values()), "K5 flags differ from its plain version")
    k5_ms = cuda_ms(lambda: mad_flag_patches(patches, SIGMA))
    k5_plain_ms = cuda_ms(lambda: mad_flag_patches_plain(patches, SIGMA))
    k5_whole_ms = cuda_ms(lambda: mad_flag_patches(wf, SIGMA), calls=5, windows=3)
    k5_bound = px * (8 + 1) / HBM_BYTES_PER_S
    log(f"K5 at (512,128,128) c64: kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms, "
        f"bound {k5_bound * 1e3:.4f} ms (bytes); design cost "
        f"{px * K5_DESIGN_OPS_PER_PIXEL / 1e9:.2f} G integer ops; whole "
        f"(8,1024,1024) {k5_whole_ms:.4f} ms")
    phases["K5"] = time.perf_counter() - t

    # -- model path ---------------------------------------------------------
    t = time.perf_counter()
    k4_launches = 0
    for path in SNAPSHOTS:
        pred = CompiledPredictor.from_snapshot(path, batch_size=BATCH)
        flag_waterfalls(wf, method="model", predictor=pred)  # warm-up
        torch.cuda.synchronize()
        fused_extract_channels.launches = 0
        mad_flag_patches.launches = 0
        rate, lo, hi, calls, flags = calls_per_s(
            lambda: flag_waterfalls(wf, method="model", predictor=pred))
        launches = fused_extract_channels.launches
        require(launches > 0, f"model path ({path}) never launched K4")
        k4_launches += launches
        require(flags.shape == wf.shape and flags.dtype == torch.bool,
                "model flags: shape or dtype")
        m = evaluate_segmentation(flags, mask)
        images = fused_extract_channels(patches)
        pred_ms = cuda_ms(lambda: pred(images), calls=5, windows=3)
        log(f"model {path.split('/')[-1]}: IoU {m['iou']:.4f} "
            f"P {m['precision']:.4f} R {m['recall']:.4f}; K4 launches "
            f"{launches} in {calls} calls; waterfalls/s on {kind}: "
            f"{rate_text(N_WATERFALLS * rate, N_WATERFALLS * lo, N_WATERFALLS * hi)}, "
            f"patches/s {n_patches * rate:.4g}; call {1e3 / rate:.3f} ms, "
            f"predictor alone {pred_ms:.3f} ms")
        require(m["iou"] > 0.9, f"model flags ({path}) miss the injected RFI")

        gpu = pred.logits(images[:8]).cpu()
        cpu_pred = CompiledPredictor.from_snapshot(path, batch_size=BATCH,
                                                   device="cpu")
        cpu = cpu_pred.logits(images[:8].cpu())
        err = float((gpu - cpu).abs().max())
        log(f"  logits card vs CPU on 8 patches: max abs diff {err:.2e} "
            f"(tol {LOGIT_TOL:g}, |logit| <= {float(cpu.abs().max()):.1f})")
        require(err <= LOGIT_TOL, "card logits disagree with the CPU")

    # the BatchNorm snapshot at patch_size=256: K4's strip kernel
    pred = CompiledPredictor.from_snapshot(SNAPSHOTS[0], batch_size=FLAG_BATCH_LARGE,
                                           input_shape=(LARGE, LARGE, 3))
    flag_waterfalls(wf, method="model", predictor=pred, patch_size=LARGE)  # warm-up
    torch.cuda.synchronize()
    fused_extract_channels.launches = 0
    t0 = time.perf_counter()
    flags = flag_waterfalls(wf, method="model", predictor=pred, patch_size=LARGE)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    k4_large_flag_launches = fused_extract_channels.launches
    plain = P.unpatchify_batch(
        pred(fused_extract_channels_plain(P.patchify_batch(wf, LARGE).contiguous())),
        N_WATERFALLS, SIDE, SIDE)
    agree = float((flags == plain).double().mean())
    m = evaluate_segmentation(flags, mask)
    log(f"model {SNAPSHOTS[0].split('/')[-1]} at patch_size={LARGE}: K4 launches "
        f"{k4_large_flag_launches} in one call ({1e3 * call_s:.1f} ms); masks agree with the "
        f"plain extraction's on {agree:.6f} of the pixels (tol {MASK_AGREE:g}); IoU "
        f"{m['iou']:.4f} (not checked: the snapshot was trained on 128^2 patches)")
    require(flags.shape == wf.shape and k4_large_flag_launches == 1,
            "the model path at patch_size=256 did not launch K4 once")
    require(agree >= MASK_AGREE, "patch_size=256: K4's masks disagree with the plain path")
    phases["model"] = time.perf_counter() - t

    # -- MAD path -----------------------------------------------------------
    t = time.perf_counter()
    flag_waterfalls(wf, method="mad", sigma=SIGMA)  # warm-up
    torch.cuda.synchronize()
    fused_extract_channels.launches = 0
    mad_flag_patches.launches = 0
    rate, lo, hi, calls, flags = calls_per_s(
        lambda: flag_waterfalls(wf, method="mad", sigma=SIGMA))
    k5_launches = mad_flag_patches.launches
    require(k5_launches > 0, "MAD path never launched K5")
    m = evaluate_segmentation(flags, mask)
    log(f"mad sigma={SIGMA:g}: IoU {m['iou']:.4f} P {m['precision']:.4f} "
        f"R {m['recall']:.4f}; K5 launches {k5_launches} in {calls} calls; "
        f"waterfalls/s on {kind}: "
        f"{rate_text(N_WATERFALLS * rate, N_WATERFALLS * lo, N_WATERFALLS * hi)}; "
        f"call {1e3 / rate:.4f} ms")
    require(m["iou"] > 0.5, "MAD flags do not find the injected RFI")
    phases["mad"] = time.perf_counter() - t


    # -- static-path data: the port's generator, bench.py's event mix ---------
    t = time.perf_counter()
    sample_fn = make_sample_generator(SIDE, SIDE, rfi_config=RFI_CONFIG,
                                      num_polarizations=1)
    twf, tmask, _ = sample_fn(N_WATERFALLS, torch.Generator(device=dev).manual_seed(SEED))
    prep = make_static_prep_fn(PATCH, K_STATIC, return_patches=False)
    b = prep.base(twf.reshape(-1, SIDE, SIDE), tmask.reshape(-1, SIDE, SIDE))
    keep = P.static_select_from_has(b.has, K_STATIC,
                                    torch.Generator(device=dev).manual_seed(0))
    base_idx, variant, pidx = prep.indices(b, keep)
    base = b.base.contiguous()  # (512, 128, 128) complex64
    m_base = base.shape[0]
    n_distinct = int(torch.unique(base_idx).numel())
    n_distinct_grad = int(torch.unique(pidx * m_base + base_idx).numel())
    variants = sorted(torch.unique(variant).tolist())
    log(f"static selection: K={K_STATIC} of {int(b.has.numel())} virtual patches "
        f"({int(b.has.sum())} flagged), {n_distinct} distinct base patches of "
        f"{m_base}, variants {variants}")
    require(variants == [0, 1, 2, 3] and n_distinct < K_STATIC,
            "the selection lacks repeats or a variant")
    phases["static data"] = time.perf_counter() - t

    # -- K2, K1, K3 ----------------------------------------------------------
    t = time.perf_counter()
    px = PATCH * PATCH
    const = torch.full((4, PATCH, PATCH), 2 + 1j, dtype=torch.complex64, device=dev)
    real_base = base.abs()  # float32 amplitudes
    nan_base = base[:64].clone()
    nan_base[(torch.rand(nan_base.shape, generator=g) < 0.01).to(dev)] = complex(float("nan"), 0.0)
    nan_base[5] = complex(float("nan"), 0.0)  # a patch of NaN only
    ragged = {"3x5": base[:16, :3, :5], "5x7": base[:16, :5, :7],
              "33x128": base[:16, :33], "128x127": base[:16, :, :127]}
    ragged = {k: v.contiguous() for k, v in ragged.items()}

    k2_err = {}
    for name, x in {f"M={m_base}": base, "constant": const, "real": real_base,
                    "NaN pixels": nan_base, **ragged}.items():
        got = ops.fused_extract_channel_planes(x)
        want = ops.fused_extract_channel_planes_plain(x)
        torch.cuda.synchronize()
        k2_err[name] = extract_err(got, want, f"K2 {name}")
    planes = ops.fused_extract_channel_planes(base)
    odd = slice(0, 37)
    small, even = base_idx < 16, base_idx % 2 == 0
    many = torch.cat([torch.full((150,), 9, device=dev), torch.tensor([1, 4], device=dev)])
    many = many[torch.randperm(many.numel(), generator=g).to(dev)]
    k1_cases = {
        f"K={K_STATIC}": (base, base_idx, pidx),
        "odd K=37": (base, base_idx[odd], pidx[odd]),
        "constant": (const, torch.tensor([0, 3, 1, 2, 3], device=dev),
                     torch.tensor([0, 1, 2, 0, 2], device=dev)),
        "real": (real_base, base_idx, pidx),
        "NaN pixels": (nan_base, base_idx[base_idx < 64], pidx[base_idx < 64]),
        "repeated pairs": (base, torch.tensor([7, 7, 7, 3, 7, 3, 7], device=dev),
                           torch.tensor([2, 2, 2, 0, 2, 1, 2], device=dev)),
        "odd bases unselected": (base, base_idx[even], pidx[even]),
        "one base 150 times": (base, many, torch.randint(0, 3, many.shape, generator=g).to(dev)),
        **{name: (x, base_idx[small], pidx[small]) for name, x in ragged.items()},
    }
    k1_err = {}
    for name, args in k1_cases.items():
        got, want = ops.fused_gather_extract(*args), ops.fused_gather_extract_plain(*args)
        torch.cuda.synchronize()
        k1_err[name] = extract_err(got, want, f"K1 {name}")
    # K3: (planes, images, identity) elements differing, and on rectangular
    # tiles (variants 0, 1) (planes, images)
    nan_sel = base_idx < 64
    k3_cases = {
        f"K={K_STATIC}": (planes, base_idx, pidx, variant),
        "odd K=37": (planes, base_idx[odd], pidx[odd], variant[odd]),
        "int32 indices": (planes, base_idx.int(), pidx.int(), variant.int()),
        "NaN pixels": (ops.fused_extract_channel_planes(nan_base), base_idx[nan_sel],
                       pidx[nan_sel], variant[nan_sel]),
        "repeated pairs, bases unselected": (
            planes, torch.tensor([7, 7, 7, 3, 7, 3, 7], device=dev),
            torch.tensor([2, 2, 2, 0, 2, 1, 2], device=dev),
            torch.tensor([3, 3, 0, 1, 2, 2, 0], device=dev)),
        "one base 150 times": (planes, many,
                               torch.randint(0, 3, many.shape, generator=g).to(dev),
                               torch.randint(0, 4, many.shape, generator=g).to(dev)),
        "K=1 of M=1": (ops.fused_extract_channel_planes(base[:1]), torch.tensor([0], device=dev),
                       torch.tensor([1], device=dev), torch.tensor([3], device=dev)),
        **{f"{s}^2": (ops.fused_extract_channel_planes(base[:16, :s, :s].contiguous()),
                      base_idx[small], pidx[small], variant[small]) for s in (33, 100, 127)},
    }
    k3_diff = {name: k3_differing(*args) for name, args in k3_cases.items()}
    for name in ("33x128", "128x127"):
        k3_diff[f"{name} (variants 0, 1)"] = k3_rect_diff(
            ops.fused_extract_channel_planes(ragged[name]), base_idx[small], pidx[small],
            variant[small] % 2)
    del k3_cases
    log("K2 max|kernel-plain|: " + ", ".join(f"{k} {v:.2e}" for k, v in k2_err.items())
        + "; K1: " + ", ".join(f"{k} {v:.2e}" for k, v in k1_err.items())
        + f" (tol {EXTRACT_TOL:g}); K3 elements differing (planes, images, identity): "
        + ", ".join(f"{k} {v}" for k, v in k3_diff.items()) + " (must be 0)")
    require(max(k2_err.values()) <= EXTRACT_TOL, "K2 disagrees with its plain version")
    require(max(k1_err.values()) <= EXTRACT_TOL, "K1 disagrees with its plain version")
    require(not any(any(v) for v in k3_diff.values()),
            "K3 is not bit-equal to its plain version")
    # a bad index traps in the kernel: the process stops
    bad = subprocess.run([sys.executable, "-c", K3_BAD_INDEX.format(root=str(Path.cwd()))],
                         capture_output=True, text=True, timeout=300)
    trapped = (bad.returncode != 0 and "good call ok" in bad.stdout
               and "bad call returned" not in bad.stdout)
    err_line = (bad.stderr.strip().splitlines() or ["(none)"])[-1]
    log(f"K3 with a base_idx past the last base patch, in a subprocess: exit {bad.returncode}, "
        f"last error line {err_line[:160]!r}")
    require(trapped, "K3: a bad index did not stop the process")

    k1_planes = ops.fused_gather_extract(base, base_idx, pidx)
    static_kernels = {
        "K2": (lambda: ops.fused_extract_channel_planes(base),
               lambda: ops.fused_extract_channel_planes_plain(base),
               bound(m_base * px * (8 + 5 * 4), m_base * px * PLANE_OPS_PER_PIXEL)),
        "K1": (lambda: ops.fused_gather_extract(base, base_idx, pidx),
               lambda: ops.fused_gather_extract_plain(base, base_idx, pidx),
               bound(n_distinct * px * 8 + K_STATIC * (2 * 4 + 3 * 4 * px),
                     n_distinct * px * PLANE_OPS_PER_PIXEL)),
        "K3": (lambda: ops.fused_plane_gather_transform(planes, base_idx, pidx, variant),
               lambda: ops.fused_plane_gather_transform_plain(planes, base_idx, pidx, variant),
               bound((n_distinct_grad + 2 * n_distinct) * px * 4
                     + K_STATIC * (3 * 4 + 3 * 4 * px), 0)),
    }
    static_ms = {}
    for name, (kernel, plain, (bound_ms, bound_by)) in static_kernels.items():
        static_ms[name] = (cuda_ms(kernel), cuda_ms(plain, calls=10, windows=3),
                           bound_ms, bound_by)
        k_ms, p_ms, _, _ = static_ms[name]
        log(f"{name} at M={m_base}, K={K_STATIC}, 128^2: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{k_ms / bound_ms:.1f}x the bound")
    # K3's identity mode reads the K gathered planes once and writes them
    k3_ms = k3_times(planes, base_idx, pidx, variant)
    k3_identity_bound = bound(2 * 3 * 4 * K_STATIC * px + 8 * K_STATIC, 0)[0]
    identity_ms = cuda_ms(lambda: ops.fused_plane_gather_transform_images(
        k1_planes, None, None, variant))
    identity_plain_ms = cuda_ms(lambda: ops.fused_plane_gather_transform_images_plain(
        k1_planes, None, None, variant), calls=10, windows=3)
    log(f"K3 at M={m_base}, K={K_STATIC}, 128^2 (bound {static_ms['K3'][2]:.4f} ms; identity "
        f"mode's {k3_identity_bound:.4f}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in k3_ms.items())
        + f"; identity mode on K1's planes (the 'auto' route's call) {identity_ms:.4f} ms, its "
        f"plain version (stack and transform) {identity_plain_ms:.4f} ms")

    # K2, K1, K3 above 128 x 128: K2 and K1 on the resident-group kernel where
    # its slabs fit, else the strip kernel (K1: the strip K2 and K3's gather),
    # every case also on both kernels launched directly; K3's 32 x 32
    # squares; at the static selections of patch 256 and 1024
    def tiled(x):
        """The 8 waterfalls of 1024^2 as 2 of 2048^2, 4 tiled 2 x 2 in each."""
        x = x.reshape(2, 2, 2, SIDE, SIDE)
        return torch.cat([torch.cat([x[:, 0, 0], x[:, 0, 1]], -1),
                          torch.cat([x[:, 1, 0], x[:, 1, 1]], -1)], -2).contiguous()

    twf2, tmask2 = tiled(twf), tiled(tmask)  # (2, 2048, 2048)
    twf4, tmask4 = (torch.cat([x[0], x[1]], -1)[None] for x in (twf2, tmask2))  # 2048 x 4096

    def selection(patch, k, wfs, masks):
        prep = make_static_prep_fn(patch, k, return_patches=False)
        sel = prep.base(wfs, masks)
        keep = P.static_select_from_has(sel.has, k, torch.Generator(device=dev).manual_seed(0))
        return (sel.base.contiguous(), *prep.indices(sel, keep))

    base256, bidx256, var256, pidx256 = selection(
        LARGE, K_LARGE, twf.reshape(-1, SIDE, SIDE), tmask.reshape(-1, SIDE, SIDE))
    m256 = base256.shape[0]
    # the 8 waterfalls of 1024^2 as base patches of the 2048^2 ones
    wf8, bidx1024, _, pidx1024 = selection(SIDE, K_WIDE, twf2, tmask2)
    wf2, bidx2048, _, pidx2048 = selection(HUGE, K_HUGE, twf4, tmask4)  # (2, 2048, 2048)
    nan_b256 = base256[:16].clone()
    nan_b256[(torch.rand(nan_b256.shape, generator=g) < 0.01).to(dev)] = complex(float("nan"), 0.0)
    nan_b256[5] = complex(float("nan"), 0.0)
    shifted_b256 = torch.empty(16 * LARGE * LARGE + 1, dtype=torch.complex64, device=dev)
    shifted_b256 = shifted_b256[1:].view(16, LARGE, LARGE)
    shifted_b256.copy_(base256[16:32])
    ragged_large = {"129x130": wf8[:, :129, :130].contiguous(),
                    "1000x1024": wf8[:2, :1000].contiguous()}
    wide8 = twf2[:1]  # one 2048^2 patch
    base512 = base256.repeat(4, 1, 1)

    def some(m, k=37):
        """k random (base_idx, pidx) over m base patches."""
        return (torch.randint(0, m, (k,), generator=g).to(dev),
                torch.randint(0, 3, (k,), generator=g).to(dev))

    large_cases = {
        "K2": {f"M={m256} 256^2": (base256,), "512x256^2": (base512,), "8x1024^2": (wf8,),
               "real 256^2": (base256.abs(),), "NaN 256^2": (nan_b256,),
               "constant 256^2": (const.new_full((3, LARGE, LARGE), 2 + 1j),),
               "8 B off 16 B": (shifted_b256,), "1x2048^2": (wide8,),
               **{k: (v,) for k, v in ragged_large.items()}},
        "K1": {f"K={K_LARGE} 256^2": (base256, bidx256, pidx256),
               "512x256^2": (base512, *some(512, 1920)),
               f"8x1024^2 K={K_WIDE}": (wf8, bidx1024, pidx1024),
               "real 256^2": (base256.abs(), bidx256, pidx256),
               "NaN 256^2": (nan_b256, *some(16)),
               "constant 256^2": (const.new_full((3, LARGE, LARGE), 2 + 1j),
                                  torch.tensor([0, 2, 0, 2], device=dev),
                                  torch.tensor([0, 1, 2, 0], device=dev)),
               "repeated pairs, bases unselected": (
                   base256, torch.tensor([7, 7, 7, 3, 7, 3, 7], device=dev),
                   torch.tensor([2, 2, 2, 0, 2, 1, 2], device=dev)),
               "one base 150 times": (base256, many,
                                      torch.randint(0, 3, many.shape, generator=g).to(dev)),
               "8 B off 16 B": (shifted_b256, *some(16)),
               "1x2048^2": (wide8, *some(1, 3)),
               **{name: (x, *some(x.shape[0], 9)) for name, x in ragged_large.items()}},
    }
    wrappers = {"K2": (ops.fused_extract_channel_planes, ops.fused_extract_channel_planes_plain),
                "K1": (ops.fused_gather_extract, ops.fused_gather_extract_plain)}
    group_err = {"K2": {}, "K1": {}}
    strip_err = {"K2": {}, "K1": {}}
    large_diff = {"K2": {}, "K1": {}}
    # the wrapper's errors by its route, and its elements off the kernel its
    # route names
    wrap_err = {op: {"groups": {}, "strips": {}} for op in ("K2", "K1")}
    wrap_diff = {"K2": {}, "K1": {}}
    for op, cases in large_cases.items():
        fn, plain = wrappers[op]
        cells = []
        for name, args in cases.items():
            got, want = fn(*args), plain(*args)
            rows, groups, strips = both_kernels(op, *args)
            torch.cuda.synchronize()
            route = route_of(op, args[0])[0]
            err = wrap_err[op][route][name] = extract_err(got, want, f"{op} {name}")
            wrap_diff[op][name] = differing(got, groups if route == "groups" else strips)
            strip_err[op][name] = extract_err(strips, want, f"{op} {name}, strip kernel")
            if groups is not None:
                group_err[op][name] = extract_err(groups, want, f"{op} {name}, group kernel")
                large_diff[op][name] = differing(groups, strips)
            cells.append(f"{name} [{route}] {err:.2e} ({wrap_diff[op][name]} differing from "
                         f"the {route} kernel's), group kernel (rows {rows}) "
                         + (f"{group_err[op][name]:.2e}, {large_diff[op][name]} "
                            "differing from the strip kernel's"
                            if groups is not None else "none fits")
                         + f", strip kernel {strip_err[op][name]:.2e}")
        log(f"{op} above 128^2, max|kernel-plain| of the wrapper by its route (and the "
            "elements it differs in from that kernel launched directly), of each kernel "
            f"launched directly, and the elements the two differ in: {'; '.join(cells)} (tol "
            f"{EXTRACT_TOL:g}; differing must be 0)")
        require(max([*wrap_err[op]["groups"].values(), *wrap_err[op]["strips"].values(),
                     *group_err[op].values(), *strip_err[op].values()]) <= EXTRACT_TOL,
                f"{op} above 128^2 disagrees with its plain version")
        require(not any(wrap_diff[op].values()),
                f"{op} above 128^2 differs from the kernel its route names")
        require(not any(large_diff[op].values()),
                f"{op}'s group kernel differs from its strip kernel")
        require(route_of(op, wide8)[0] == "strips" and route_of(op, base256)[0] == "groups",
                f"{op}: 2048^2 does not take the strip route or 256^2 the group route")
    del got, want, groups, strips, base512
    # the group kernel on two streams at once: its grid is launched
    # cooperatively, so it never starts part-resident beside another grid
    # whose slabs it would wait behind (K2 on a real 2048^2 patch: 512 slabs
    # of 4 rows, nearly the whole resident grid)
    real2048 = wide8.abs().contiguous()
    require(route_of("K2", real2048)[0] == "groups", "K2 on real 2048^2: not the group route")
    alone = ops.fused_extract_channel_planes(real2048)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    together = []
    for st in streams:
        with torch.cuda.stream(st):
            together += [ops.fused_extract_channel_planes(real2048) for _ in range(4)]
    torch.cuda.synchronize()
    stream_diff = sum(differing(o, alone) for o in together)
    log(f"K2 on a real 2048^2 patch (group route, 512 slabs), 4 calls on each of 2 streams at "
        f"once: {stream_diff} elements differing from a call alone (must be 0)")
    require(stream_diff == 0, "K2's group kernel on two streams differs from a call alone")
    del real2048, alone, together
    planes256 = ops.fused_extract_channel_planes(base256)
    every_variant = torch.arange(19, device=dev) % 4
    k3_large_diff = {}
    for name, args in {f"K={K_LARGE} 256^2": lambda: (planes256, bidx256, pidx256, var256),
                       "odd K=37 256^2": lambda: (planes256, bidx256[:37], pidx256[:37],
                                                  var256[:37]),
                       "8x1024^2": lambda: (ops.fused_extract_channel_planes(wf8), *some(8, 19),
                                            every_variant),
                       "1x2048^2": lambda: (ops.fused_extract_channel_planes(wide8), *some(1, 5),
                                            every_variant[:5])}.items():
        k3_large_diff[name] = k3_differing(*args())
    for name, x in ragged_large.items():
        k3_large_diff[f"{name} (variants 0, 1)"] = k3_rect_diff(
            ops.fused_extract_channel_planes(x), *some(x.shape[0], 9),
            torch.randint(0, 2, (9,), generator=g).to(dev))
    log("K3 above 128 elements differing (planes, images, identity): "
        + ", ".join(f"{k} {v}" for k, v in k3_large_diff.items()) + " (must be 0)")
    require(not any(any(v) for v in k3_large_diff.values()), "K3 above 128 is not bit-equal")

    px256 = LARGE * LARGE
    distinct256 = int(torch.unique(bidx256).numel())
    distinct_grad256 = int(torch.unique(pidx256 * m256 + bidx256).numel())
    distinct1024 = int(torch.unique(bidx1024).numel())
    p32 = base256[:32]
    px1024 = SIDE * SIDE
    px2048 = HUGE * HUGE
    distinct2048 = int(torch.unique(bidx2048).numel())
    n_wide = wf8.shape[0]
    # name -> (kernel, arguments, bound); K3's bound: the selected planes read,
    # the outputs and indices moved
    large_kernels = {
        "K2 (32,256,256)": ("K2", (p32,), bound(32 * px256 * (8 + 5 * 4),
                                                32 * px256 * PLANE_OPS_PER_PIXEL)),
        "K2": ("K2", (base256,), bound(m256 * px256 * (8 + 5 * 4),
                                       m256 * px256 * PLANE_OPS_PER_PIXEL)),
        "K1": ("K1", (base256, bidx256, pidx256),
               bound(distinct256 * px256 * 8 + K_LARGE * (2 * 4 + 3 * 4 * px256),
                     distinct256 * px256 * PLANE_OPS_PER_PIXEL)),
        "K3": ("K3", (planes256, bidx256, pidx256, var256),
               bound((distinct_grad256 + 2 * distinct256) * px256 * 4
                     + K_LARGE * (3 * 4 + 3 * 4 * px256), 0)),
        "K2 (8,1024,1024)": ("K2", (wf8,), bound(n_wide * px1024 * (8 + 5 * 4),
                                                 n_wide * px1024 * PLANE_OPS_PER_PIXEL)),
        "K1 (8,1024,1024)": ("K1", (wf8, bidx1024, pidx1024),
                             bound(distinct1024 * px1024 * 8
                                   + K_WIDE * (2 * 4 + 3 * 4 * px1024),
                                   distinct1024 * px1024 * PLANE_OPS_PER_PIXEL)),
        "K2 (2,2048,2048)": ("K2", (wf2,), bound(2 * px2048 * (8 + 5 * 4),
                                                 2 * px2048 * PLANE_OPS_PER_PIXEL)),
        "K1 (2,2048,2048)": ("K1", (wf2, bidx2048, pidx2048),
                             bound(distinct2048 * px2048 * 8
                                   + K_HUGE * (2 * 4 + 3 * 4 * px2048),
                                   distinct2048 * px2048 * PLANE_OPS_PER_PIXEL)),
    }
    large_ms, other_ms = {}, {}
    for name, (op, args, (bound_ms, bound_by)) in large_kernels.items():
        if op == "K3":
            fn = ops.fused_plane_gather_transform
            plain = ops.fused_plane_gather_transform_plain
        else:
            fn, plain = wrappers[op]
        large_ms[name] = (cuda_ms(lambda: fn(*args), calls=20, windows=3),
                          cuda_ms(lambda: plain(*args), calls=5, windows=3), bound_ms, bound_by)
        k_ms, p_ms, _, _ = large_ms[name]
        where = name.split(" ", 1)[1] if " " in name else f"M={m256}, K={K_LARGE}, 256^2"
        line = (f"{name.split()[0]} above 128^2 at {where}: wrapper {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"{k_ms / bound_ms:.1f}x the bound")
        if op != "K3":
            route = route_of(op, args[0])
            other = "strips" if route[0] == "groups" else "groups"
            call, _, rows = direct_kernel(op, other, *args)
            other_ms[name] = cuda_ms(call, calls=20, windows=3) if call else None
            once, counts, traces = port_kernels(lambda: fn(*args), route_kernels(op, route[0]))
            line += (f"; route {route}, {launched_text(counts, traces)}; the {other} route "
                     "launched directly "
                     + (f"{other_ms[name]:.4f} ms" + (f" (rows {rows})" if rows else "")
                        if call else "fits no slab"))
            require(once, f"{name}: not the {route[0]} route's kernels once a call")
        log(line)
    k3_large_ms = k3_times(planes256, bidx256, pidx256, var256)
    log(f"K3 at M={m256}, K={K_LARGE}, 256^2 (bound {large_ms['K3'][2]:.4f} ms): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in k3_large_ms.items()))
    phases["K1-K3"] = time.perf_counter() - t

    # -- static prep through create_dataset ------------------------------------
    t = time.perf_counter()

    def reset_counts():
        for fn in (ops.fused_gather_extract, ops.fused_extract_channel_planes,
                   ops.fused_plane_gather_transform, fused_extract_channels,
                   mad_flag_patches, ops.conv3x3_call, ops.conv3x3_dw,
                   ops.double_conv_gn_relu):
            fn.launches = 0

    def counts():
        return {"K1": ops.fused_gather_extract.launches,
                "K2": ops.fused_extract_channel_planes.launches,
                "K3": ops.fused_plane_gather_transform.launches,
                "K4": fused_extract_channels.launches,
                "K5": mad_flag_patches.launches}

    prep_launches = {}
    twf_real = twf.abs()
    static = dict(static_num_patches=K_STATIC)
    routes = {"auto": dict(extract="auto", flags=tmask),
              "planes": dict(extract="planes", flags=tmask),
              "mad": dict(extract="auto", flags=None),
              "real auto": dict(extract="auto", flags=tmask, data=twf_real),
              "real planes": dict(extract="planes", flags=tmask, data=twf_real),
              "real materialised": dict(flags=tmask, data=twf_real,
                                        size=dict(num_patches=K_STATIC)),
              "auto 256": dict(extract="auto", flags=tmask, patch=LARGE,
                               size=dict(static_num_patches=K_LARGE)),
              "planes 256": dict(extract="planes", flags=tmask, patch=LARGE,
                                 size=dict(static_num_patches=K_LARGE)),
              "auto 1024": dict(extract="auto", flags=tmask2[:, None], data=twf2[:, None],
                                patch=SIDE, size=dict(static_num_patches=K_WIDE)),
              "planes 1024": dict(extract="planes", flags=tmask2[:, None],
                                  data=twf2[:, None], patch=SIDE,
                                  size=dict(static_num_patches=K_WIDE)),
              "auto 2048": dict(extract="auto", flags=tmask4[:, None], data=twf4[:, None],
                                patch=HUGE, size=dict(static_num_patches=K_HUGE)),
              "planes 2048": dict(extract="planes", flags=tmask4[:, None],
                                  data=twf4[:, None], patch=HUGE,
                                  size=dict(static_num_patches=K_HUGE))}
    for route, cfg in routes.items():
        def run(use_kernels):
            pre = Preprocessor(cfg.get("data", twf), flags=cfg["flags"])
            ds = pre.create_dataset(patch_size=cfg.get("patch", PATCH), seed=0,
                                    extract=cfg.get("extract", "auto"),
                                    use_custom_flags=cfg["flags"] is not None,
                                    use_kernels=use_kernels,
                                    **cfg.get("size", static))
            return pre.keep, ds
        run(True)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        keep_k, ds_k = run(True)
        torch.cuda.synchronize()
        prep_launches[route] = counts()
        keep_p, ds_p = run(False)
        torch.cuda.synchronize()
        err = float((ds_k.images - ds_p.images).abs().max())
        same_keep = bool(torch.equal(keep_k, keep_p))
        same_labels = bool(torch.equal(ds_k.labels, ds_p.labels))
        log(f"create_dataset route {route}: launches "
            + ", ".join(f"{k} {v}" for k, v in prep_launches[route].items() if v)
            + f"; images max|kernels-plain| {err:.2e}, labels equal {same_labels}, "
            f"same keep {same_keep}, flagged share of labels "
            f"{float(ds_k.labels.float().mean()):.4f}")
        n_out = K_STATIC if "size" not in cfg else keep_k.numel()
        side = cfg.get("patch", PATCH)
        require(ds_k.images.shape == (n_out, side, side, 3), f"{route}: image shape")
        require(same_keep and same_labels and err <= EXTRACT_TOL,
                f"create_dataset route {route}: kernels disagree with the plain path")
    # each route's launches, exactly: 'auto' K1 then K3's variant transform
    # into the images, 'planes' K2 then K3's gather into them
    for route in routes:
        want = ({"K4": 1} if route == "real materialised"
                else {"K2": 1, "K3": 1} if "planes" in route else {"K1": 1, "K3": 1})
        if route == "mad":
            want["K5"] = 1
        got = {k: v for k, v in prep_launches[route].items() if v}
        require(got == want, f"create_dataset route {route}: launches {got}, not {want}")
    # no pass over image-sized tensors outside the kernels: the profiler
    # sees the old epilogue's stack and where (a control), none on the routes
    control = image_passes(lambda: transform_by_variant_nhwc(
        torch.stack(k1_planes, dim=-1), variant), K_STATIC, PATCH)
    require("stack" in control and "where" in control,
            f"the profiler did not see the old epilogue's stack and where: {control}")
    passes = {}
    for route in ("auto", "planes", "auto 256", "planes 256"):
        cfg = routes[route]
        passes[route] = image_passes(lambda: Preprocessor(twf, flags=cfg["flags"]).create_dataset(
            patch_size=cfg.get("patch", PATCH), seed=0, extract=cfg["extract"],
            use_custom_flags=True, **cfg.get("size", static)),
            K_STATIC if "size" not in cfg else K_LARGE, cfg.get("patch", PATCH))
    log("image-sized aten stack, cat, where, copy_ on the routes (torch.profiler): "
        + ", ".join(f"{k} {v}" for k, v in passes.items())
        + f" (must be none; the old epilogue, as a control: {control})")
    require(not any(passes.values()), "a static-prep route still passes over its images")
    phases["static prep"] = time.perf_counter() - t

    # -- the training main path ----------------------------------------------------
    t = time.perf_counter()
    model = UNet(init_features=32, norm="batch", dtype=torch.bfloat16)
    state = create_train_state(model, seed=1)

    def dataset(i):
        wf, mask, _ = sample_fn(N_WATERFALLS,
                                torch.Generator(device=dev).manual_seed(SEED + i))
        ds = Preprocessor(wf, flags=mask).create_dataset(
            patch_size=PATCH, use_custom_flags=True, seed=0,
            static_num_patches=K_STATIC)
        return (ds.images.reshape(STEPS, TRAIN_BATCH, PATCH, PATCH, 3),
                ds.labels.reshape(STEPS, TRAIN_BATCH, PATCH, PATCH))

    def iteration(i):
        return train_steps(state, *dataset(i))[1]

    first = iteration(0)  # warm-up
    first_loss = float(first.mean())
    torch.cuda.synchronize()
    log(f"train warm-up iteration: {time.perf_counter() - t:.1f} s, mean loss "
        f"{first_loss:.4f}")
    reset_counts()
    rates, windows_losses, it = [], [], 1
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        while time.perf_counter() - t0 < WINDOW_S:
            losses.append(iteration(it))
            it += 1
        torch.cuda.synchronize()
        rates.append(len(losses) * K_STATIC / (time.perf_counter() - t0))
        windows_losses.append(torch.stack(losses).cpu())
    iterations = sum(len(w) for w in windows_losses)
    train_launches = counts()
    per_iter = [float(x.mean()) for w in windows_losses for x in w]
    last_loss = float(windows_losses[-1].mean())
    rate = statistics.median(rates)
    log(f"train loop on {kind}: patches/s {rate_text(rate, min(rates), max(rates))} "
        f"({iterations} iterations of {K_STATIC}); K1 launches "
        f"{train_launches['K1']} (K2 {train_launches['K2']}, K3 "
        f"{train_launches['K3']}, K4 {train_launches['K4']})")
    log("mean loss per iteration: " + " ".join(f"{x:.4f}" for x in per_iter))
    require(all(bool(torch.isfinite(w).all()) for w in windows_losses),
            "a training loss is not finite")
    require(train_launches["K1"] == iterations and train_launches["K3"] == iterations,
            "K1 and K3 did not run once each per iteration of the training path")
    require(last_loss < first_loss, "the loss did not fall over training")

    images, labels = dataset(it)
    train_ms = cuda_ms(lambda: train_steps(state, images, labels), calls=2, windows=3)
    prep_ms = cuda_ms(lambda: dataset(it), calls=5, windows=3)
    flops = unet_train_flops_analytic(TRAIN_BATCH) * STEPS
    tflops = flops / (train_ms / 1e3) / 1e12
    log(f"train only: {train_ms:.1f} ms per {STEPS} steps of {TRAIN_BATCH} "
        f"({K_STATIC / (train_ms / 1e3):.1f} patches/s), {tflops:.1f} TFLOP/s "
        f"({100 * tflops * 1e12 / BF16_PEAK_FLOPS:.1f}% of the {BF16_PEAK_FLOPS / 1e12:.0f} "
        f"TFLOP/s bf16 peak; {flops / STEPS / 1e12:.3f} TFLOP per step); generation + "
        f"static prep alone {prep_ms:.2f} ms per iteration; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # two float32 steps (TF32 off) on the card and on the CPU from the same
    # seeded weights and images. Float32 gradients of this network carry
    # about 1e-3 relative error (BatchNorm's backward cancels), so the
    # card's step-1 gradient is held to float64 as closely as the CPU's,
    # and the optimiser on the card is fed the CPU's gradients.
    def fresh(device=None):
        return create_train_state(UNet(init_features=32, norm="batch"), seed=2,
                                  device=device)

    def recorded(state):
        seen = []
        apply = state.apply_gradients

        def record(grads):
            seen.append([g.detach().cpu() for g in grads])
            apply(grads)
        state.apply_gradients = record
        return seen

    def flat(tensors):
        return torch.cat([t.detach().cpu().double().flatten() for t in tensors])

    s_cpu, s_gpu, s_opt = fresh("cpu"), fresh(), fresh()
    start = flat(s_cpu.params)
    x, y = images[:2, :8], labels[:2, :8]
    m64 = copy.deepcopy(s_cpu.model).double().train()
    m64.dtype = torch.float64
    loss64 = bce_dice_loss(m64(x[0].cpu().double().permute(0, 3, 1, 2))[:, 0], y[0].cpu())
    g64 = flat(torch.autograd.grad(loss64, list(m64.parameters())))
    g_cpu, g_gpu = recorded(s_cpu), recorded(s_gpu)
    _, l_gpu = train_steps(s_gpu, x, y)
    _, l_cpu = train_steps(s_cpu, x.cpu(), y.cpu())
    for grads in g_cpu:
        s_opt.apply_gradients([g.to(dev) for g in grads])
    l_gpu, l_cpu = l_gpu.cpu().double(), l_cpu.double()
    rel = float(((l_gpu - l_cpu).abs() / l_cpu.abs()).max())
    err_cpu = float((flat(g_cpu[0]) - g64).norm() / g64.norm())
    err_gpu = float((flat(g_gpu[0]) - g64).norm() / g64.norm())
    lr = s_cpu.learning_rate
    p_cpu = flat(s_cpu.params)
    opt_diff = float((flat(s_opt.params) - p_cpu).abs().max()) / lr
    path_agree = float((((flat(s_gpu.params) - start) - (p_cpu - start)).abs()
                        <= OPT_ATOL_LR * lr).double().mean())
    log(f"float32 train steps on 8 images: losses card "
        f"{' '.join(f'{v:.6f}' for v in l_gpu.tolist())}, CPU "
        f"{' '.join(f'{v:.6f}' for v in l_cpu.tolist())}, max rel diff {rel:.2e} "
        f"(tol {F32_LOSS_RTOL:g}); step-1 gradient off float64 by {err_gpu:.3e} "
        f"(card) and {err_cpu:.3e} (CPU) in norm (card at most 2x the CPU); "
        f"optimiser fed the CPU's gradients: max |param diff| {opt_diff:.2e} * lr "
        f"(tol {OPT_ATOL_LR:g}); the two paths' updates agree within "
        f"{OPT_ATOL_LR:g} * lr on {path_agree:.4f} of the coordinates (not checked)")
    require(rel <= F32_LOSS_RTOL, "float32 train steps: card and CPU losses disagree")
    require(err_gpu <= 2 * err_cpu, "float32 gradient: the card is far from float64")
    require(opt_diff <= OPT_ATOL_LR, "the optimiser on the card disagrees with the CPU's")
    phases["train"] = time.perf_counter() - t

    # -- K6a on the folded UNet16 (serving) ------------------------------------------
    t = time.perf_counter()
    images_train, labels_train = images, labels  # phase 9's last dataset, (15, 128, ...)
    images = fused_extract_channels(patches)  # phase 5's 512 images

    def conv_bound(n, h, w, ci, co):
        """(ms, kind) of a 3x3 conv's float32 work: each input read and
        output written once, the products of conv3x3_flops."""
        return bound(4 * (n * h * w * (ci + co) + 9 * ci * co + co),
                     conv3x3_flops(n, h, w, ci, co), F32_PRODUCT_OPS_PER_S)

    def convs_of(model):
        return [m for m in model.modules()
                if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3)]

    def blocks_of(model):
        return [m for m in model.modules() if isinstance(m, DoubleConv)]

    def capture(modules, run):
        """Each module's first input and output during run()."""
        seen = {}

        def hook(module, inputs, output):
            seen.setdefault(module, (inputs[0], output))

        hooks = [m.register_forward_hook(hook) for m in modules]
        run()
        for h in hooks:
            h.remove()
        return [seen[m] for m in modules]

    def hwio(conv):
        return conv.weight.permute(2, 3, 1, 0).contiguous()

    def summed(rows):
        keys = ("ms", "plain_ms", "library_ms", "bound_ms")
        total = {k: sum(r[k] for r in rows) for k in keys}
        ops_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        total["bound_by"] = "operations" if 2 * ops_ms >= total["bound_ms"] else "bytes"
        return total

    def rate(rows):
        """Direct-equivalent TFLOP/s of the kernel and of the library call
        over the layers, and the library's time over the kernel's."""
        gflop = sum(r["gflop"] for r in rows)
        ms, lib_ms = sum(r["ms"] for r in rows), sum(r["library_ms"] for r in rows)
        return (f"direct-equivalent {gflop / ms:.1f} TFLOP/s (library {gflop / lib_ms:.1f}), "
                f"{lib_ms / ms:.2f}x faster than the library")

    def layer_log(name, rows):
        """Each layer's line; fails if a measured time is under the bound,
        which would make the bound no floor."""
        for r in rows:
            log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
                f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), "
                f"{r['ms'] / r['bound_ms']:.1f}x the bound (library "
                f"{r['library_ms'] / r['bound_ms']:.1f}x), {r['library_ms'] / r['ms']:.2f}x "
                f"faster than the library; direct-equivalent {r['gflop'] / r['ms']:.1f} "
                f"TFLOP/s (library {r['gflop'] / r['library_ms']:.1f}); err vs plain "
                f"{r['err_plain']:.1e}, vs library {r['err_library']:.1e} (share of the "
                f"output's max)")
        under = [r["shape"] for r in rows
                 if min(r["ms"], r["plain_ms"], r["library_ms"]) < r["bound_ms"]]
        require(not under, f"{name}: measured under the bound at {under}")

    pred = CompiledPredictor.from_snapshot(SNAPSHOTS[0], batch_size=BATCH)
    convs = convs_of(pred.model)
    require(pred.folded and len(convs) == 18, "the folded UNet16 has 18 conv3x3 layers")
    k6a_rows = []
    require(pred.route == "k6a_nhwc", f"the folded UNet16 takes the {pred.route} route")

    def eager_logits(pred, x):  # the model's own NCHW forward: cuDNN, TF32 off
        with torch.inference_mode():
            return pred.model(x.permute(0, 3, 1, 2))[:, 0]

    with torch.inference_mode():
        seen = capture(convs, lambda: eager_logits(pred, images[:BATCH]))
        for conv, (x_nchw, y_conv) in zip(convs, seen):
            x = x_nchw.permute(0, 2, 3, 1).contiguous()
            xl = x.permute(0, 3, 1, 2)  # channels-last NCHW view, cuDNN's NHWC kernels
            w, b = hwio(conv), conv.bias
            wl = conv.weight.contiguous(memory_format=torch.channels_last)
            y = ops.conv3x3_call(x, w, b, relu=True)
            y_plain = ops.conv3x3_call_plain(x, w, b, relu=True)
            y_layer = torch.relu(y_conv).permute(0, 2, 3, 1)  # the model's cuDNN layer
            scale = float(y_layer.abs().max())
            n, h, wd, ci = x.shape
            co = w.shape[3]
            bound_ms, bound_by = conv_bound(n, h, wd, ci, co)
            k6a_rows.append({
                "shape": f"({n},{h},{wd},{ci})->{co}",
                "gflop": direct_gflop(n, h, wd, ci, co),
                "err_abs": float((y - y_plain).abs().max()),
                "err_plain": float((y - y_plain).abs().max()) / scale,
                "err_library": float((y - y_layer).abs().max()) / scale,
                "ms": cuda_ms(lambda: ops.conv3x3_call(x, w, b, relu=True), calls=20, windows=3),
                "plain_ms": cuda_ms(lambda: ops.conv3x3_call_plain(x, w, b, relu=True),
                                    calls=20, windows=3),
                "library_ms": cuda_ms(lambda: torch.cudnn_convolution_relu(
                    xl, wl, b, (1, 1), (1, 1), (1, 1), 1), calls=20, windows=3),
                "bound_ms": bound_ms, "bound_by": bound_by})
    layer_log("K6a", k6a_rows)
    k6a = summed(k6a_rows)
    worst = max(max(r["err_plain"], r["err_library"]) for r in k6a_rows)
    log(f"K6a over the 18 layers of the folded UNet16 at batch {BATCH}: kernel "
        f"{k6a['ms']:.3f} ms, plain {k6a['plain_ms']:.3f}, cuDNN conv+bias+ReLU "
        f"{k6a['library_ms']:.3f}, bound {k6a['bound_ms']:.3f} ({k6a['bound_by']}); worst "
        f"error {worst:.1e} of the layer's max |y| (tol {CONV_RTOL:g}); {rate(k6a_rows)}")
    require(worst <= CONV_RTOL, "K6a disagrees with its plain version or the cuDNN layer")

    def route_check(pred, route, name, launches_of, per_forward, atol, imgs, flag_call, truth,
                    iou_floor=0.9, f64_ratio=None):
        """The predictor's own channels-last route against its eager forward
        (the model's NCHW modules: cuDNN, TF32 off) on imgs: launches a
        forward and in one flag_call() (which flags imgs' waterfalls
        through pred), logits, masks, IoU against truth (held to iou_floor
        unless it is None). Both forwards' distances from a float64 copy of
        the model say how far the eager reference is itself. The logits are
        held to the eager forward's within atol; with f64_ratio, for inputs
        on which a float32 forward lies that far from float64 by itself,
        to the float64 forward's within max(atol, f64_ratio times the eager
        forward's distance from it) instead. Returns the call's launches."""
        require(pred.route == route, f"{name}: the predictor takes the {pred.route} route")
        n_imgs = len(imgs)
        chunks = [imgs[i:i + BATCH] for i in range(0, n_imgs, BATCH)]
        reset_counts()
        got = pred.logits(chunks[0])
        torch.cuda.synchronize()
        launches = launches_of()
        got = torch.cat([got] + [pred.logits(c) for c in chunks[1:]])
        want = torch.cat([eager_logits(pred, c) for c in chunks])
        with torch.inference_mode():
            model64 = copy.deepcopy(pred.model).double()
            model64.dtype = torch.float64  # forward casts x to dtype, logits to float32
            want64 = torch.cat([model64(c.double().permute(0, 3, 1, 2))[:, 0] for c in chunks])
            del model64
        gap = float((got - want).abs().max())
        f64_route = float((got - want64).abs().max())
        f64_eager = float((want - want64).abs().max())
        del want64
        masks = pred(imgs)
        p_want = torch.sigmoid(want)
        differ = masks != (p_want > pred.threshold)
        off_edge = int((differ & ((p_want - pred.threshold).abs() > gap)).sum())
        route_ms = cuda_ms(lambda: pred(imgs), calls=3, windows=3)
        eager_ms = cuda_ms(lambda: [eager_logits(pred, c) for c in chunks], calls=3, windows=3)
        flag_call()  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        flags = flag_call()
        torch.cuda.synchronize()
        call_launches = launches_of()
        m = evaluate_segmentation(flags, truth)
        log(f"{name} ({pred.route}): {launches} launches a forward of {BATCH}, "
            f"{call_launches} in one flagging call of {n_imgs} images; logits within {gap:.2e} "
            f"of the eager cuDNN forward; from a float64 forward: route {f64_route:.2e}, eager "
            f"{f64_eager:.2e} (tol {atol:g}"
            + ("" if f64_ratio is None else f", from float64 or {f64_ratio:g}x the eager's")
            + f"); masks differ on "
            f"{int(differ.sum())} pixels, {off_edge} of them clear of the cut by more than the "
            f"gap; IoU {m['iou']:.4f}; predictor on {n_imgs} images {route_ms:.2f} ms through "
            f"the route, the eager forwards {eager_ms:.2f} ms")
        require(launches == per_forward, f"{name}: the route did not launch the kernel "
                                         "once per layer")
        require(call_launches == per_forward * len(chunks),
                f"{name}: the main path did not launch the kernel once per layer of each "
                "forward")
        if f64_ratio is None:
            require(gap <= atol, f"{name}: the route's logits are far from the eager forward's")
        else:
            require(f64_route <= max(atol, f64_ratio * f64_eager),
                    f"{name}: the route's logits are far from the float64 forward's")
        require(off_edge == 0, f"{name}: the route's masks differ from the eager forward's off "
                               "the cut")
        if iou_floor is not None:
            require(m["iou"] > iou_floor, f"{name}: the route's flags miss the injected RFI")
        return call_launches

    # the predictor's own route: its channels-last forward, K6a with bias and ReLU fused
    k6a_launches = route_check(
        pred, "k6a_nhwc", "K6a, the folded UNet16's route", lambda: ops.conv3x3_call.launches,
        18, ROUTE_LOGITS_ATOL, images, lambda: flag_waterfalls(wf, method="model", predictor=pred),
        mask)
    phases["K6a"] = time.perf_counter() - t

    # -- K7 on the GroupNorm UNet16 (serving) -----------------------------------------
    t = time.perf_counter()
    pred = CompiledPredictor.from_snapshot(SNAPSHOTS[1], batch_size=BATCH)
    blocks = blocks_of(pred.model)
    require(pred.model.norm == "group" and len(blocks) == 9,
            "the GroupNorm UNet16 has 9 DoubleConvs")

    def k7_args(dc):
        return (hwio(dc.conv1), dc.norm1.weight, dc.norm1.bias, hwio(dc.conv2),
                dc.norm2.weight, dc.norm2.bias)

    def k7_check(pred, imgs, name):
        """K7 on each DoubleConv of pred's model, on the block's input in
        the eager forward of imgs[:BATCH], against its plain version and
        the module (cuDNN + group_norm, TF32 off): one row a block, with
        times and bounds. Fails past K7_RTOL."""
        blocks = blocks_of(pred.model)
        rows = []
        with torch.inference_mode():
            seen = capture(blocks, lambda: eager_logits(pred, imgs[:BATCH]))
            for dc, (x_nchw, y_block) in zip(blocks, seen):
                x = x_nchw.permute(0, 2, 3, 1).contiguous()
                xl = x.permute(0, 3, 1, 2)
                args = k7_args(dc)
                kw = dict(num_groups=dc.norm1.num_groups, eps=dc.norm1.eps)
                y = ops.double_conv_gn_relu(x, *args, **kw)
                y_plain = ops.double_conv_gn_relu_plain(x, *args, **kw)
                y_layer = y_block.permute(0, 2, 3, 1)
                scale = float(y_layer.abs().max())
                n, h, wd, ci = x.shape
                co = args[0].shape[3]
                bound_ms, bound_by = bound(
                    4 * (n * h * wd * (ci + co) + 9 * ci * co + 9 * co * co + 4 * co),
                    conv3x3_flops(n, h, wd, ci, co) + conv3x3_flops(n, h, wd, co, co),
                    F32_PRODUCT_OPS_PER_S)
                rows.append({
                    "shape": f"({n},{h},{wd},{ci})->{co}, {kw['num_groups']} groups",
                    "gflop": direct_gflop(n, h, wd, ci, co) + direct_gflop(n, h, wd, co, co),
                    "err_abs": float((y - y_plain).abs().max()),
                    "err_plain": float((y - y_plain).abs().max()) / scale,
                    "err_library": float((y - y_layer).abs().max()) / scale,
                    "ms": cuda_ms(lambda: ops.double_conv_gn_relu(x, *args, **kw), calls=20,
                                  windows=3),
                    "plain_ms": cuda_ms(lambda: ops.double_conv_gn_relu_plain(x, *args, **kw),
                                        calls=20, windows=3),
                    "library_ms": cuda_ms(lambda: dc(xl), calls=20, windows=3),
                    "bound_ms": bound_ms, "bound_by": bound_by})
        layer_log("K7", rows)
        total = summed(rows)
        worst = max(max(r["err_plain"], r["err_library"]) for r in rows)
        log(f"K7 over the {len(rows)} DoubleConvs of {name} at batch {BATCH}: kernel "
            f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f}, DoubleConv (cuDNN + "
            f"group_norm) {total['library_ms']:.3f}, bound {total['bound_ms']:.3f} "
            f"({total['bound_by']}); worst error {worst:.1e} of the block's max |y| (tol "
            f"{K7_RTOL:g}); {rate(rows)}")
        require(worst <= K7_RTOL, f"{name}: K7 disagrees with its plain version or the DoubleConv")
        return rows, total

    k7_rows, k7 = k7_check(pred, images, "the GroupNorm UNet16")

    # the predictor's own route: its channels-last forward, each DoubleConv one K7 call
    k7_launches = route_check(
        pred, "k7_nhwc", "K7, the GroupNorm UNet16's route",
        lambda: ops.double_conv_gn_relu.launches, 9, K7_ROUTE_LOGITS_ATOL, images,
        lambda: flag_waterfalls(wf, method="model", predictor=pred), mask)
    phases["K7"] = time.perf_counter() - t

    # -- K6a + K6b in a float32 UNet32 training step -----------------------------------
    t = time.perf_counter()
    x_train, y_train = images_train[0], labels_train[0]  # 128 static-prep patches
    ref_state = create_train_state(UNet(init_features=32, norm="batch"), seed=3)
    k_model = copy.deepcopy(ref_state.model)
    m64 = copy.deepcopy(ref_state.model).double()
    m64.dtype = torch.float64  # the same step in float64 (cuDNN), the yardstick
    grads_out = {}

    def through_conv3x3(conv):
        def forward(x):
            y = ops.conv3x3(x.permute(0, 2, 3, 1), conv.weight.permute(2, 3, 1, 0), conv.bias)
            if y.requires_grad:
                saved_inputs[conv] = x.permute(0, 2, 3, 1).detach()
                y.register_hook(lambda g: grads_out.__setitem__(conv, g.contiguous()))
            return y.permute(0, 3, 1, 2)
        return forward

    saved_inputs = {}
    k_convs = convs_of(k_model)
    for conv in k_convs:
        conv.forward = through_conv3x3(conv)

    def loss_and_grads(model):
        model.train()
        x = x_train.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        loss = bce_dice_loss(model(x)[:, 0], y_train)
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    reset_counts()
    loss_k, grads_k = loss_and_grads(k_model)
    torch.cuda.synchronize()
    k6a_train, k6b_launches = ops.conv3x3_call.launches, ops.conv3x3_dw.launches
    loss_r, grads_r = loss_and_grads(ref_state.model)
    step_ms = cuda_ms(lambda: loss_and_grads(k_model), calls=3, windows=3)
    ref_ms = cuda_ms(lambda: loss_and_grads(ref_state.model), calls=3, windows=3)
    grads_64 = loss_and_grads(m64)[1]
    del m64

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    names = [n for n, _ in k_model.named_parameters()]
    overall = rel(torch.cat([g.flatten() for g in grads_k]),
                  torch.cat([g.flatten() for g in grads_r]))
    to_64 = {n: (rel(a, c), rel(b, c)) for n, a, b, c in zip(names, grads_k, grads_r, grads_64)
             if float(c.norm()) > 0}
    worst = max(to_64, key=lambda n: to_64[n][0] / max(2 * to_64[n][1], GRAD_F64_FLOOR))
    loss_k, loss_r = float(loss_k.detach()), float(loss_r.detach())
    log(f"float32 UNet32 step at batch {TRAIN_BATCH} through K6a + K6b: loss {loss_k:.7f} "
        f"vs cuDNN {loss_r:.7f} (rel {abs(loss_k - loss_r) / abs(loss_r):.1e}, tol "
        f"{TRAIN_LOSS_RTOL:g}); all gradients off cuDNN's by {overall:.2e} in relative L2 "
        f"(tol {GRAD_RTOL:g}); off float64, per parameter, median "
        f"{statistics.median(v[0] for v in to_64.values()):.1e} (cuDNN "
        f"{statistics.median(v[1] for v in to_64.values()):.1e}), nearest its bound "
        f"{worst}: {to_64[worst][0]:.2e} against cuDNN's {to_64[worst][1]:.2e} (tol 2x cuDNN's "
        f"or {GRAD_F64_FLOOR:g}); launches K6a {k6a_train} (18 forward + 17 dx), K6b "
        f"{k6b_launches}; forward+backward {step_ms:.2f} ms, cuDNN {ref_ms:.2f} ms")
    log("  per parameter, off float64 (K6a + K6b, cuDNN): " + ", ".join(
        f"{n} {a:.1e} {b:.1e}" for n, (a, b) in to_64.items()))
    require(abs(loss_k - loss_r) <= TRAIN_LOSS_RTOL * abs(loss_r),
            "K6a/K6b step: loss disagrees with cuDNN's")
    require(overall <= GRAD_RTOL, "K6a/K6b step: gradients disagree with cuDNN's")
    require(all(a <= max(2 * b, GRAD_F64_FLOOR) for a, b in to_64.values()),
            f"K6a/K6b step: the gradient of {worst} is far from float64")
    require(k6a_train == 35 and k6b_launches == 18,
            "the training step did not run K6a forward and dx and K6b once per layer")

    k6b_rows, deterministic = [], True
    with torch.no_grad():
        for conv in k_convs:
            x, g = saved_inputs[conv], grads_out[conv]
            xl, gl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            wl = conv.weight.contiguous(memory_format=torch.channels_last)
            dw = ops.conv3x3_dw(x, g)
            deterministic &= bool(torch.equal(dw, ops.conv3x3_dw(x, g)))
            dw_plain = ops.conv3x3_dw_plain(x, g)

            def library():
                return torch.ops.aten.convolution_backward(
                    gl, xl, wl, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                    [False, True, False])[1]
            dw_lib = library().permute(2, 3, 1, 0)
            scale = float(dw_lib.abs().max())
            n, h, wd, ci = x.shape
            co = g.shape[3]
            bound_ms, bound_by = bound(4 * (n * h * wd * (ci + co) + 9 * ci * co),
                                       conv3x3_flops(n, h, wd, ci, co), F32_PRODUCT_OPS_PER_S)
            k6b_rows.append({
                "shape": f"({n},{h},{wd},{ci})x({co})",
                "gflop": direct_gflop(n, h, wd, ci, co),
                "err_abs": float((dw - dw_plain).abs().max()),
                "err_plain": float((dw - dw_plain).abs().max()) / scale,
                "err_library": float((dw - dw_lib).abs().max()) / scale,
                "ms": cuda_ms(lambda: ops.conv3x3_dw(x, g), calls=10, windows=3),
                "plain_ms": cuda_ms(lambda: ops.conv3x3_dw_plain(x, g), calls=10, windows=3),
                "library_ms": cuda_ms(library, calls=10, windows=3),
                "bound_ms": bound_ms, "bound_by": bound_by})
    for conv in k_convs:
        del conv.forward
    layer_log("K6b", k6b_rows)
    k6b = summed(k6b_rows)
    worst = max(max(r["err_plain"], r["err_library"]) for r in k6b_rows)
    log(f"K6b over the 18 layers of UNet32 at batch {TRAIN_BATCH}: kernel {k6b['ms']:.3f} ms, "
        f"plain {k6b['plain_ms']:.3f}, cuDNN weight gradient {k6b['library_ms']:.3f}, bound "
        f"{k6b['bound_ms']:.3f} ({k6b['bound_by']}); worst error {worst:.1e} of max |dW| (tol "
        f"{DW_RTOL:g}); two runs bit-equal: {deterministic}; {rate(k6b_rows)}")
    require(worst <= DW_RTOL, "K6b disagrees with its plain version or cuDNN")
    require(deterministic, "K6b is not deterministic")
    phases["K6a+K6b train"] = time.perf_counter() - t

    # -- train -> export -> serve ---------------------------------------------------
    t = time.perf_counter()
    out_dir = Path("build/chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)

    def static_dataset(seed, k):
        wf_s, mask_s, _ = sample_fn(N_WATERFALLS, torch.Generator(device=dev).manual_seed(seed))
        return Preprocessor(wf_s, flags=mask_s).create_dataset(
            patch_size=PATCH, use_custom_flags=True, seed=0, static_num_patches=k)

    trainer = Trainer(UNet(init_features=32, norm="batch", dtype=torch.bfloat16),
                      checkpoint_dir=out_dir, seed=1)
    result = trainer.fit(static_dataset(SEED + 1000, K_STATIC), static_dataset(SEED + 2000, 256),
                         num_epochs=1, batch_size=TRAIN_BATCH, fused_steps=STEPS)
    rec = result["history"][0]
    log(f"Trainer.fit, 1 epoch of {K_STATIC} at batch {TRAIN_BATCH} (bf16): train loss "
        f"{rec['train_loss']:.4f}, val loss {rec['val_loss']:.4f}, val IoU {rec['val_iou']:.4f}, "
        f"{rec['seconds']:.2f} s; {trainer.state.step} steps")
    require(trainer.state.step == STEPS and np.isfinite(rec["val_loss"]),
            "Trainer.fit did not take one epoch of finite steps")
    snapshot = export_params(trainer.state, out_dir / "unet32.npz")
    served = CompiledPredictor.from_snapshot(snapshot, batch_size=BATCH)
    flags = flag_waterfalls(wf, method="model", predictor=served)
    # the same float32 parameters computing in float32: a checkpoint of the
    # bf16 trainer restored into a float32 UNet32
    path = trainer.save_checkpoint("smoke", 1, rec["train_loss"])
    f32 = Trainer(UNet(init_features=32, norm="batch"), seed=7)
    f32.restore(path)

    def trainer_flags(tr, tta=False):
        return P.unpatchify_batch(tr.predict(images, batch_size=BATCH, tta=tta),
                                  N_WATERFALLS, SIDE, SIDE)

    agree = float((flags == trainer_flags(f32)).double().mean())
    agree_bf16 = float((flags == trainer_flags(trainer)).double().mean())
    tta = trainer.predict(images[:BATCH], batch_size=BATCH, tta=True)
    log(f"served snapshot (float32, BatchNorm folded): flags agree with Trainer.predict "
        f"on {agree:.6f} of the pixels (the trained weights in float32, unfolded; tol "
        f"{MASK_AGREE:g}) and on {agree_bf16:.6f} with the bf16 trainer's own predict "
        f"(not checked: bf16 rounding moves the pixels near the threshold of a model "
        f"trained for {STEPS} steps); predict(tta=True) {tuple(tta.shape)}, flagged share "
        f"{float(tta.float().mean()):.4f}")
    require(served.folded and served.model.depth == 4, "the snapshot did not load as UNet32")
    require(agree >= MASK_AGREE, "the served snapshot disagrees with Trainer.predict")
    require(tta.shape == (BATCH, PATCH, PATCH) and tta.dtype == torch.bool, "predict(tta=True)")

    restored = Trainer(UNet(init_features=32, norm="batch", dtype=torch.bfloat16), seed=7)
    require(restored.restore(path) == 1, "restore did not return the epoch")
    sd_a, sd_b = trainer.state.model.state_dict(), restored.state.model.state_dict()
    same = all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a) and all(
        torch.equal(a, b) for a, b in zip(trainer.state.mu + trainer.state.nu,
                                          restored.state.mu + restored.state.nu))
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        batch = (images_train[1], labels_train[1])
        train_step(trainer.state, *batch)
        train_step(restored.state, *batch)
        torch.cuda.synchronize()
        next_same = all(torch.equal(a, b) for a, b in zip(trainer.state.params,
                                                          restored.state.params))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    log(f"checkpoint {path.name}: restored state bit-equal {same}; the next step "
        f"(deterministic algorithms) bit-equal {next_same}")
    require(same and next_same, "a restored checkpoint differs from the saved state")
    shutil.rmtree(out_dir)  # some 300 MB of checkpoints
    phases["train-export-serve"] = time.perf_counter() - t

    # -- the file path: generator -> batch files -> streamed Trainer.fit ---------------
    t = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    made = {}
    for name, cfg in (("train", TRAIN_4K_CONFIG), ("val", VAL_1K_CONFIG)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        SyntheticDataGenerator(cfg, seed=SEED).generate(out_dir / name)
        torch.cuda.synchronize()
        made[name] = {"generate_s": time.perf_counter() - t0, **counts()}
    train_dir, val_dir = out_dir / "train" / "exact_masks", out_dir / "val" / "exact_masks"
    meta = json.loads((train_dir / "metadata.json").read_text())
    gen_meta = json.loads((out_dir / "train" / "generation_metadata.json").read_text())
    mad_meta = json.loads((out_dir / "train" / "mad_masks" / "metadata.json").read_text())
    val_meta = json.loads((val_dir / "metadata.json").read_text())
    events = json.loads((out_dir / "train" / "rfi_parameters.json").read_text())
    synth = TRAIN_4K_CONFIG["synthetic"]
    n_wf = synth["num_samples"] * synth["num_polarizations"]  # 32 whole waterfalls
    n_train = n_wf * TRAIN_4K_CONFIG["processing"]["augmentation_rotations"]
    n_val = VAL_1K_CONFIG["synthetic"]["num_samples"] * synth["num_polarizations"]
    batch_files = sorted(p.name for p in train_dir.glob("batch_*.npz"))
    disk_gb = sum(f.stat().st_size for f in out_dir.rglob("*") if f.is_file()) / 1e9
    n_gen = -(-synth["num_samples"] // synth["generation_batch_size"])
    log(f"file path: generated {meta['num_samples']} images {meta['image_shape']} in "
        f"{batch_files} ({disk_gb:.2f} GB on disk with the MAD masks and validation), "
        f"{mad_meta['num_samples']} MAD-mask waterfalls, {len(events)} samples' events; "
        + "; ".join(f"{k}: generation, preprocessing and writes {v['generate_s']:.2f} s, "
                    f"K4 launches {v['K4']}, K5 {v['K5']}" for k, v in made.items()))
    require(meta["num_samples"] == gen_meta["num_patches"] == n_train
            and meta["num_batches"] == len(batch_files) == -(-n_train // 100)
            and meta["image_shape"] == [SIDE, SIDE, 3] and meta["format"] == "preprocessed",
            "the training batch files do not match their metadata")
    require(mad_meta["num_samples"] == n_wf and len(events) == synth["num_samples"]
            and val_meta["num_samples"] == n_val, "the MAD masks or events are miscounted")
    require(made["train"]["K4"] == n_gen and made["train"]["K5"] == n_gen
            and made["val"]["K4"] == 1 and made["val"]["K5"] == 0,
            "generation did not launch K4 and K5 once a generation batch")

    # the MAD masks against K5's plain version on the file's own magnitudes
    with np.load(out_dir / "train" / "mad_masks" / "batch_000.npz") as f:
        mags = torch.as_tensor(f["images"]).to(dev)
        mad_labels = torch.as_tensor(f["labels"]).to(dev)
    mad_sigma = float(TRAIN_4K_CONFIG["processing"]["flag_sigma"])
    mad_plain = ops.mad_flag_patches_plain(mags, mad_sigma)
    mad_diff = int((mad_plain.to(torch.uint8) != mad_labels).sum())
    log(f"  the {len(mags)} MAD masks against K5's plain version on the file's magnitudes: "
        f"{mad_diff} pixels differ, {float(mad_labels.float().mean()):.4f} flagged")
    require(mad_diff == 0, "the generated MAD masks differ from K5's plain version")
    del mags, mad_labels, mad_plain
    # the writer alone: the first training batch file's arrays put back on
    # the card and written again as generate writes them (the copy to the
    # host, the concatenation, the file write); the copy must equal the file
    with np.load(train_dir / batch_files[0]) as f:
        x_file, y_file = f["images"], f["labels"]
    x_dev, y_dev = torch.as_tensor(x_file).to(dev), torch.as_tensor(y_file).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    writer = BatchWriter(out_dir / "rewrite", samples_per_batch=100)
    writer.add_batch(ArrayDataset(x_dev, y_dev))
    writer.finalize()
    write_s = time.perf_counter() - t0
    with np.load(out_dir / "rewrite" / "batch_000.npz") as f:
        same_file = np.array_equal(f["images"], x_file) and np.array_equal(f["labels"], y_file)
    log(f"  the writer alone on {len(x_file)} images of 1024^2 from the card: {write_s:.2f} s "
        f"({x_file.nbytes / write_s / 1e9:.2f} GB/s of images); the copy equals the file "
        f"{same_file}")
    require(same_file, "BatchWriter's copy of a batch file differs from it")
    del x_dev, y_dev, x_file, y_file
    shutil.rmtree(out_dir / "rewrite")

    stream = StreamingDataset(train_dir)
    trainer = Trainer(UNet(init_features=32, norm="batch", dtype=torch.bfloat16), seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.fit(stream, str(val_dir), num_epochs=1, batch_size=FIT_BATCH)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rec = result["history"][0]
    log(f"Trainer.fit on the streamed files (UNet32 bf16, batch {FIT_BATCH}): "
        f"{trainer.state.step} steps, {trainer.state.step * FIT_BATCH} of {len(stream)} "
        f"samples; train loss {rec['train_loss']:.4f}, val loss {rec['val_loss']:.4f}, val IoU "
        f"{rec['val_iou']:.4f}; epoch {rec['seconds']:.2f} s ({n_train / rec['seconds']:.1f} "
        f"images of 1024^2 a second, {n_train * (SIDE // PATCH) ** 2 / rec['seconds']:.0f} "
        f"128^2-patch equivalents), fit with validation {fit_s:.2f} s; resident batch files "
        f"at most {stream.max_resident_files}, shuffle pool at most {stream.pool_peak_files} "
        f"files, reader {stream.last_reader}")
    require(trainer.state.step * FIT_BATCH == n_train == len(stream),
            "the epoch did not consume every sample")
    require(stream.max_resident_files <= 3, "more than 3 batch files resident")
    require(np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
            and np.isfinite(rec["val_iou"]), "file path: a loss or the val IoU is not finite")
    file_path_launches = made["train"]["K4"] + made["val"]["K4"]
    # where the epoch's time goes: the same steps on one minibatch already
    # on the card, against the epoch (file reads, the shuffle pool, copies)
    t0 = time.perf_counter()
    for xh, yh in stream.iter_epoch(FIT_BATCH, np.random.default_rng(0)):
        pass  # the epoch's reads and shuffle pool alone
    read_s = time.perf_counter() - t0
    copy_ms = cuda_ms(lambda: (torch.as_tensor(xh).to(dev, torch.float32),
                               torch.as_tensor(yh).to(dev, torch.float32)), calls=3, windows=3)
    x = torch.as_tensor(xh).to(dev, torch.float32)
    y = torch.as_tensor(yh).to(dev, torch.float32)
    step_ms = cuda_ms(lambda: train_step(trainer.state, x, y), calls=3, windows=3)
    n_steps = n_train // FIT_BATCH
    log(f"  where the epoch's {rec['seconds']:.2f} s go: its {n_steps} steps on minibatches "
        f"already on the card {n_steps * step_ms / 1e3:.2f} s ({step_ms:.1f} ms a step); the "
        f"stream's file reads and shuffle pool alone {read_s:.2f} s; the minibatches' copies "
        f"to the card {n_steps * copy_ms / 1e3:.2f} s ({copy_ms:.1f} ms each, pageable)")
    del x, y, xh, yh
    shutil.rmtree(out_dir)  # some 1.8 GB of batch files
    phases["file path"] = time.perf_counter() - t

    # -- the raw-patch path: DevicePreprocessor -> RawPatchTrainer ------------------------
    t = time.perf_counter()
    raw_pre = DevicePreprocessor(wf, mask)
    raw, raw_masks = raw_pre.create_raw_patches(seed=0)
    require(tuple(raw.shape[1:]) == (RAW_PATCH, RAW_PATCH) and raw.is_cuda
            and len(raw) >= RAW_BATCH, "create_raw_patches: shape or device")
    raw_trainer = RawPatchTrainer(UNet(init_features=32, norm="batch", dtype=torch.bfloat16),
                                  seed=1)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = raw_trainer.fit(raw, raw_masks, num_epochs=1, batch_size=RAW_BATCH)
    torch.cuda.synchronize()
    raw_s = time.perf_counter() - t0
    raw_steps = raw_trainer.state.step
    raw_launches = fused_extract_channels.launches
    raw_loss = result["history"][0]["train_loss"]
    log(f"raw-patch path: {len(raw)} patches of {RAW_PATCH}^2 "
        f"({raw_pre.estimate_storage_mb():.1f} MiB), RawPatchTrainer UNet32 bf16 "
        f"1 epoch at batch {RAW_BATCH}: {raw_steps} steps, K4 launches {raw_launches}, mean "
        f"loss {raw_loss:.4f}, {raw_s:.2f} s ({raw_steps * RAW_BATCH / raw_s:.1f} patches/s, "
        f"the first step's cuDNN set-up included)")
    require(raw_steps == len(raw) // RAW_BATCH and raw_launches == raw_steps,
            "the raw-patch path did not launch K4 once a step")
    require(np.isfinite(raw_loss), "the raw-patch path's loss is not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = raw_trainer.fit(raw, raw_masks, num_epochs=RAW_WARM_EPOCHS, batch_size=RAW_BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_steps = RAW_WARM_EPOCHS * raw_steps
    log(f"  {RAW_WARM_EPOCHS} warm epochs back to back (cuDNN set up): {warm_steps} steps in "
        f"{warm_s:.3f} s, {warm_steps * RAW_BATCH / warm_s:.1f} patches/s, "
        f"{warm_s / warm_steps * 1e3:.2f} ms a step")
    require(all(np.isfinite(r["train_loss"]) for r in warm["history"]),
            "the raw-patch path's warm losses are not finite")
    phases["raw-patch path"] = time.perf_counter() - t
    del raw, raw_masks, raw_pre, raw_trainer

    # -- 16: the coherent simulator on the card ------------------------------------------
    t = time.perf_counter()
    sim = RFISimulator(SIDE, SIDE)
    g16 = torch.Generator(device=dev).manual_seed(SEED)
    draws = sim.draw(N_WATERFALLS, g16)
    k_cpu = 2  # samples rendered again on the CPU
    cpu_sim = RFISimulator(SIDE, SIDE, device="cpu")
    cpu_draws = tree_to(draws, "cpu", k_cpu)
    for gibbs in (False, True):
        sim.gibbs_ringing = cpu_sim.gibbs_ringing = gibbs
        tf16, mask16 = sim.render(draws)
        draw_ms = cuda_ms(lambda: sim.draw(N_WATERFALLS, g16), calls=3, windows=3)
        render_ms = cuda_ms(lambda: sim.render(draws), calls=3, windows=3)
        fam_masks, band, amp = simulator_truth(sim, draws)
        union = torch.stack(list(fam_masks.values())).any(0)
        truth_diff = int(((mask16 != union) & ~band).sum())
        cpu_tf, cpu_mask = cpu_sim.render(cpu_draws)
        card_tf, band_cpu = tf16[:k_cpu].cpu(), band[:k_cpu].cpu()
        mask_diff = int(((mask16[:k_cpu].cpu() != cpu_mask) & ~band_cpu).sum())
        mag = cpu_tf.abs()
        rel = ((card_tf.abs() - mag).abs() / mag).max()
        err = (card_tf - cpu_tf).abs()
        room = float((err / (MAG_RTOL * mag + 1e-6 * amp[:k_cpu].cpu())).max())
        log(f"simulator {N_WATERFALLS} x 4 pols x {SIDE}^2, Gibbs ringing {gibbs}: "
            f"{(draw_ms + render_ms) / N_WATERFALLS:.3f} ms a sample (draw {draw_ms:.2f} ms, "
            f"render {render_ms:.2f} ms a batch); masked share {float(mask16.float().mean()):.4f}"
            f", by family " + ", ".join(f"{k} {float(v.float().mean()):.4f}"
                                        for k, v in fam_masks.items())
            + f"; the mask against the draws' truth: {truth_diff} pixels differ outside the "
            f"floor band ({int(band.sum())} pixels in it); card vs CPU on {k_cpu} samples: "
            f"{mask_diff} mask pixels differ outside the band, max |d|field|| / |field| "
            f"{float(rel):.2e}, max |d field| / (1e-5 |field| + 1e-6 S) {room:.3f}")
        require(truth_diff == 0, "the simulator's mask is not its draws' truth")
        require(mask_diff == 0, "the simulator's masks differ between the card and the CPU")
        require(room <= 1.0, "the simulator's planes differ between the card and the CPU")
        if not gibbs:  # phases 17(b) and 18 take these planes
            coh_tf, coh_mask = tf16, mask16
    del draws, cpu_draws, tf16, cpu_tf, card_tf, amp, band, fam_masks, union
    phases["simulator"] = time.perf_counter() - t

    # -- 17: physics gates on the port's own stream --------------------------------------
    t = time.perf_counter()
    gate_size = 256  # every coherent snapshot's train_size
    gate = [coherent_batch(torch.Generator(device=dev).manual_seed(HELD_OUT_KEY + j),
                           GATE_BATCH, gate_size) for j in range(GATE_BATCHES)]
    gate_rows = {}
    for name, (floor, tta_floor) in COHERENT_GATES.items():
        path = f"pretrained/{name}.npz"
        meta = load_params(path)[2]
        require(meta["train_size"] == [gate_size, gate_size] and meta["in_channels"] == 8,
                f"{name}: not an 8-channel snapshot of train_size {gate_size}")
        pred = CompiledPredictor.from_snapshot(path, batch_size=GATE_BATCH,
                                               input_shape=(gate_size, gate_size, 8))

        def probs(x):
            return torch.sigmoid(pred.logits(x))

        plain, tta = [], []
        for x, gt in gate:
            p = probs(x)
            plain.append(evaluate_segmentation(p > pred.threshold, gt)["iou"])
            p = (p + probs(x.flip(1)).flip(1) + probs(x.flip(2)).flip(2)
                 + probs(x.flip(1, 2)).flip(1, 2)) / 4
            tta.append(evaluate_segmentation(p > pred.threshold, gt)["iou"])
        iou, iou_tta = float(np.mean(plain)), float(np.mean(tta))
        gate_rows[name] = (iou, iou_tta)
        log(f"gate {name} (threshold {pred.threshold:g}, folded {pred.folded}): held-out IoU "
            f"{iou:.4f} (floor {floor}), TTA {iou_tta:.4f}"
            + (f" (floor {tta_floor})" if tta_floor is not None else " (no TTA gate)")
            + f"; {GATE_BATCHES} batches of {GATE_BATCH} at {gate_size}^2")
        require(iou >= floor, f"{name}: held-out IoU {iou:.4f} under its floor {floor}")
        if tta_floor is not None:
            require(iou_tta >= tta_floor and iou_tta > iou,
                    f"{name}: TTA IoU {iou_tta:.4f} under its floor {tta_floor} or the plain IoU")
    del gate
    upred = CompiledPredictor.from_snapshot(UNIVERSAL, batch_size=BATCH)
    rr = coh_tf[:, 0].contiguous()  # the RR planes
    flag_waterfalls(rr, method="model", predictor=upred)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    uflags = flag_waterfalls(rr, method="model", predictor=upred)
    torch.cuda.synchronize()
    universal_launches = fused_extract_channels.launches
    m = evaluate_segmentation(uflags, coh_mask)
    log(f"gate {UNIVERSAL.split('/')[-1]} through flag_waterfalls(method='model') on the RR "
        f"planes of {N_WATERFALLS} simulator waterfalls of {SIDE}^2: IoU {m['iou']:.4f} "
        f"(floor {UNIVERSAL_FLOOR}), P {m['precision']:.4f} R {m['recall']:.4f}; "
        f"K4 launches {universal_launches}")
    require(universal_launches == 1, "the universal snapshot's flagging did not launch K4 once")
    require(m["iou"] >= UNIVERSAL_FLOOR, "the universal snapshot misses its simulator gate")
    del rr, uflags, upred
    phases["coherent gates"] = time.perf_counter() - t

    # -- 18: flag_waterfalls_coherent at full width --------------------------------------
    t = time.perf_counter()
    vis4 = coh_tf  # (8 baselines, 4 pols, SIDE, SIDE)
    ragged = vis4[:, :, :RAGGED_C].contiguous()
    images = coherent_images(vis4, PATCH)
    images_ms = cuda_ms(lambda: coherent_images(vis4, PATCH), calls=5, windows=3)
    for name in COHERENT_FLAGGERS:
        path = f"pretrained/{name}.npz"
        pred = CompiledPredictor.from_snapshot(path, batch_size=BATCH)
        flag_waterfalls_coherent(vis4, pred)  # warm-up
        call_rate, lo, hi, calls, flags = calls_per_s(lambda: flag_waterfalls_coherent(vis4, pred))
        require(flags.shape == coh_mask.shape and flags.dtype == torch.bool,
                "coherent flags: shape or dtype")
        m = evaluate_segmentation(flags, coh_mask)
        pred_ms = cuda_ms(lambda: pred(images), calls=3, windows=3)
        cpu_pred = CompiledPredictor.from_snapshot(path, batch_size=CPU_PREDICT_BATCH,
                                                   device="cpu")
        agree = float((flags[:1].cpu() == flag_waterfalls_coherent(
            vis4[:1].cpu(), cpu_pred, device="cpu")).double().mean())
        rflags = flag_waterfalls_coherent(ragged, pred)
        r_agree = float((rflags[:1].cpu() == flag_waterfalls_coherent(
            ragged[:1].cpu(), cpu_pred, device="cpu")).double().mean())
        rm = evaluate_segmentation(rflags, coh_mask[:, :RAGGED_C])
        log(f"flag_waterfalls_coherent {name} ({len(images)} images of {PATCH}^2 x 8, batch "
            f"{BATCH}, folded {pred.folded}): IoU {m['iou']:.4f} P {m['precision']:.4f} R "
            f"{m['recall']:.4f}; waterfalls/s (one pol's plane each) on {kind}: "
            f"{rate_text(*(4 * N_WATERFALLS * v for v in (call_rate, lo, hi)))}"
            f" ({N_WATERFALLS * call_rate:.4g} baselines/s) in "
            f"{calls} calls, {1e3 / call_rate:.2f} ms a call: images {images_ms:.3f} ms, predictor "
            f"{pred_ms:.2f} ms; the card's masks equal the CPU's on one baseline on {agree:.6f} "
            f"of the pixels; ragged {RAGGED_C} x {SIDE}: IoU {rm['iou']:.4f}, against the CPU "
            f"{r_agree:.6f} (tol {MASK_AGREE:g})")
        require(agree >= MASK_AGREE and r_agree >= MASK_AGREE,
                f"{name}: coherent flags differ between the card and the CPU")
        require(rflags.shape == (N_WATERFALLS, RAGGED_C, SIDE), "ragged coherent flags: shape")
        if name == COHERENT_FLAGGERS[0]:  # the coherent cell's model, on K7's route
            k7_check(pred, images, name)
            route_check(pred, "k7_nhwc", f"K7, {name}'s route",
                        lambda: ops.double_conv_gn_relu.launches, 9, K7_ROUTE_LOGITS_ATOL, images,
                        lambda: flag_waterfalls_coherent(vis4, pred), coh_mask, iou_floor=None,
                        f64_ratio=K7_ROUTE_F64_RATIO)
    del images, flags, rflags, vis4, ragged, coh_tf, coh_mask
    phases["coherent flagging"] = time.perf_counter() - t

    # -- 19: CoherentTrainer, the flagship recipe ----------------------------------------
    t = time.perf_counter()
    coh_dir = out_dir / "coherent"
    shutil.rmtree(coh_dir, ignore_errors=True)
    ckpt = coh_dir / f"step_{COH_CKPT}.pt"
    a = CoherentTrainer(**COHERENT_RECIPE, seed=SEED)
    require(a.model.dtype == torch.bfloat16, "CoherentTrainer's 'auto' dtype is not bf16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = a.fit(COH_CKPT, fused_steps=10, log_every=10)["history"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    a.save_checkpoint(ckpt)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        history += a.fit(COH_STEPS - COH_CKPT, fused_steps=10, log_every=10)["history"]
        b = CoherentTrainer(**COHERENT_RECIPE, seed=SEED)
        b.restore_checkpoint(ckpt, num_steps_hint=COH_STEPS)
        b.fit(COH_STEPS - COH_CKPT, fused_steps=10, log_every=10)
    finally:
        torch.backends.cudnn.deterministic = False
    losses = [h["loss"] for h in history]
    with torch.no_grad():
        worst = max(float(((x - y).abs() / (RESUME_ATOL + RESUME_RTOL * y.abs())).max())
                    for x, y in zip(a.state.params + a.ema_params,
                                    b.state.params + b.ema_params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.fit(COH_TIMED, fused_steps=COH_TIMED, log_every=COH_TIMED)
    torch.cuda.synchronize()
    steps_s = COH_TIMED / (time.perf_counter() - t0)
    x, y = a.sample(a.step)
    sample_ms = cuda_ms(lambda: a.sample(0), calls=5, windows=3)
    step_ms = cuda_ms(lambda: a.train_step(x, y), calls=5, windows=3)
    # the sample batch's parts: the draw, the render, the 8 channels' robust scale
    g19 = torch.Generator(device=dev).manual_seed(SEED)
    d19 = a.sim.draw(a.batch_size, g19)
    tf19 = a.sim.render(d19)[0]
    parts_ms = {"draw": cuda_ms(lambda: a.sim.draw(a.batch_size, g19), calls=5, windows=3),
                "render": cuda_ms(lambda: a.sim.render(d19), calls=5, windows=3),
                "robust scale": cuda_ms(lambda: robust_scale(to_8ch(tf19)), calls=5, windows=3)}
    del d19, tf19
    log(f"CoherentTrainer {COHERENT_RECIPE}, bf16: losses every 10 steps "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; the first {COH_CKPT} steps (cuDNN set-up "
        f"included) {first_s:.2f} s; {COH_TIMED} steps timed after: {steps_s:.2f} steps/s on "
        f"{kind} (a sample batch {sample_ms:.2f} ms: " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts_ms.items()) + f"; a step on it {step_ms:.2f} ms); resumed "
        f"from step {COH_CKPT} against the uninterrupted run (deterministic cuDNN): params and "
        f"EMA at {worst:.3g} of rtol {RESUME_RTOL:g} + atol {RESUME_ATOL:g}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            "CoherentTrainer: a loss is not finite or the loss did not fall")
    require(worst <= 1.0, "CoherentTrainer: the resumed run differs from the uninterrupted one")
    snap = a.export(coh_dir / "unet24gn.npz", best_threshold=0.5)
    size = COHERENT_RECIPE["size"]
    pred = CompiledPredictor.from_snapshot(snap, batch_size=GATE_BATCH,
                                           input_shape=(size, size, 8))
    loaded = CoherentTrainer.load(snap, dtype=torch.float32)
    report = loaded.evaluate(num_batches=1, eval_batch=GATE_BATCH, thresholds=[0.5])
    x, gt = coherent_batch(torch.Generator(device=dev).manual_seed(HELD_OUT_KEY), GATE_BATCH,
                           size)
    served = float(evaluate_segmentation_batch(pred(x), gt)["iou"].mean())
    log(f"  export -> CompiledPredictor.from_snapshot: held-out IoU at 0.5 {served:.4f}; "
        f"CoherentTrainer.load(...).evaluate(num_batches=1): {report['best_iou']:.4f}; "
        f"the training model's evaluate: {a.evaluate(num_batches=1)['best_iou']:.4f}")
    require(abs(served - report["best_iou"]) <= 1e-3,
            "the served snapshot disagrees with the loaded trainer's evaluation")
    shutil.rmtree(coh_dir)
    phases["coherent training"] = time.perf_counter() - t

    # -- 20: serve the shipped SOLOLite detector ------------------------------------------
    t = time.perf_counter()
    served = InstanceTrainer.load(SOLOLITE, batch_size=INST_BATCH, seed=0)
    cpu_served = InstanceTrainer.load(SOLOLITE, batch_size=INST_BATCH, seed=0, device="cpu")
    held = served.generate_batch(torch.Generator(device=dev).manual_seed(INST_HELD_OUT))
    images20 = fused_extract_channels(held["waterfall"])  # (64, 128, 128, 3)
    n_cmp = 8
    card = served.predict(images20[:n_cmp], score_thresh=0.3)
    host = cpu_served.predict(images20[:n_cmp].cpu(), score_thresh=0.3)
    kept_equal = cls_equal = True
    score_err, mask_agree = 0.0, []
    for c, h in zip(card, host):
        kept = (c["scores"] >= 0.3) | (h["scores"] >= 0.3)
        kept_equal &= bool(np.array_equal(c["scores"] >= 0.3, h["scores"] >= 0.3))
        cls_equal &= bool(np.array_equal(c["classes"][kept], h["classes"][kept]))
        score_err = max(score_err, float(np.abs(c["scores"] - h["scores"]).max()))
        mask_agree.append(float((c["masks"] == h["masks"]).mean()))
    n_kept = sum(int((c["scores"] >= 0.3).sum()) for c in card)
    log(f"SOLOLite {SOLOLITE.split('/')[-1]} card against CPU (TF32 off) on {n_cmp} held-out "
        f"images of {PATCH}^2: kept detections equal {kept_equal} ({n_kept} kept at 0.3), their "
        f"classes equal {cls_equal}, max |score diff| {score_err:.2e} (tol {INST_TOL:g}), masks "
        f"equal on {min(mask_agree):.6f} of the pixels (tol {MASK_AGREE:g})")
    require(kept_equal and cls_equal, "SOLOLite: the card's detections differ from the CPU's")
    require(score_err <= INST_TOL, "SOLOLite: the card's scores differ from the CPU's")
    require(min(mask_agree) >= MASK_AGREE, "SOLOLite: the card's masks differ from the CPU's")
    del cpu_served, card, host
    inst_eval_launches = 0
    for mix, gate in INSTANCE_GATES.items():
        tr = InstanceTrainer.load(SOLOLITE, batch_size=INST_BATCH, seed=0,
                                  rfi_config=gate["rfi_config"])
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = evaluate_instance_model(tr, num_images=INST_IMAGES, seed=INST_HELD_OUT,
                                    score_thresh=gate["score"])
        eval_s = time.perf_counter() - t0
        launches = fused_extract_channels.launches
        inst_eval_launches += launches
        per_class = q["per_class_recall"]
        rec_floor, rec_text = gate["recall"], f"floor {gate['recall']}"
        if "recall_reference" in gate:
            ref = gate["recall_reference"]
            rec_floor = ref - 3 * np.sqrt(ref * (1 - ref) / q["n_gt"])
            rec_text = (f"floor {rec_floor:.4f}: the float32 reference {ref} less 3 standard "
                        f"errors; the JAX gate's {gate['recall']} "
                        + ("met" if q["recall"] >= gate["recall"] else "missed"))
        log(f"gate SOLOLite, {mix} mix at score {gate['score']}: recall {q['recall']:.4f} "
            f"({rec_text}), precision {q['precision']:.4f}"
            + (f" (floor {gate['precision']})" if "precision" in gate else "")
            + f", mean best IoU {q['mean_best_iou']:.4f}, n_gt {q['n_gt']} (> {gate['n_gt']}), "
            f"n_det {q['n_det']}; per family " + ", ".join(
                f"{c} {r:.3f}" for c, r in per_class.items())
            + (f" (floor {gate['family']})" if "family" in gate else "")
            + f"; {INST_IMAGES} images in {eval_s:.2f} s; K4 launches {launches}")
        require(launches == INST_IMAGES // INST_BATCH,
                f"SOLOLite {mix} gate: K4 did not run once an evaluation batch")
        require(q["n_gt"] > gate["n_gt"], f"SOLOLite {mix} gate: too few ground-truth events")
        require(q["recall"] >= rec_floor, f"SOLOLite {mix} gate: recall under its floor")
        if "precision" in gate:
            require(q["precision"] >= gate["precision"],
                    f"SOLOLite {mix} gate: precision under its floor")
        if "family" in gate:
            require(len(per_class) == gate["families"]
                    and min(per_class.values()) >= gate["family"],
                    f"SOLOLite {mix} gate: a family is missing or under its floor")
    with torch.no_grad():
        out20 = served.model(images20)
        fwd_ms = cuda_ms(lambda: served.model(images20), calls=5, windows=3)
        dec_ms = cuda_ms(lambda: solo_decode(out20, score_thresh=0.3,
                                             out_size=(PATCH, PATCH)), calls=5, windows=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served.predict(images20, score_thresh=0.3)
    predict_ms = (time.perf_counter() - t0) * 1e3
    log(f"  SOLOLite per batch of {INST_BATCH} on {kind}: forward {fwd_ms:.3f} ms, decode + "
        f"Matrix-NMS at {PATCH}^2 {dec_ms:.3f} ms, predict with the masks' copy to the host "
        f"{predict_ms:.1f} ms (host clock, one call)")
    del out20, served
    phases["instance serving"] = time.perf_counter() - t

    # -- 21: InstanceTrainer at the shipped recipe ----------------------------------------
    t = time.perf_counter()
    inst_dir = out_dir / "instance"
    shutil.rmtree(inst_dir, ignore_errors=True)
    warmup = min(500, max(INST_STEPS // 4, 1))
    schedule = warmup_cosine_decay_schedule(1e-5, 8e-4, warmup, max(INST_STEPS, warmup + 1),
                                            end_value=1e-5)

    def recipe(**kwargs):
        kwargs = {"batch_size": INST_BATCH, "learning_rate": schedule, "seed": SEED, **kwargs}
        return InstanceTrainer(model=SOLOLite(**INST_MODEL), patch_size=PATCH, **kwargs)

    def capture_losses(trainer):
        """Every step's loss of the fused groups (fit logs each group's last)."""
        seen, fused = [], trainer._fused

        def run(state, generators):
            state, losses, parts = fused(state, generators)
            seen.append(losses)
            return state, losses, parts
        trainer._fused = run
        return seen

    a = recipe()
    seen = capture_losses(a)
    ckpt = inst_dir / f"step_{INST_CKPT}.pt"
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.fit(INST_CKPT, fused_steps=10, log_every=10)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    a.save_checkpoint(ckpt)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        history = a.fit(INST_STEPS - INST_CKPT, fused_steps=10, log_every=10)["history"]
        torch.cuda.synchronize()
        inst_train_launches = fused_extract_channels.launches
        b = recipe()
        b.restore_checkpoint(ckpt)
        b.fit(INST_STEPS - INST_CKPT, fused_steps=10, log_every=10)
    finally:
        torch.backends.cudnn.deterministic = False
    losses = torch.cat(seen).cpu().double()
    with torch.no_grad():
        worst = max(float(((x - y).abs() / (RESUME_ATOL + RESUME_RTOL * y.abs())).max())
                    for x, y in zip(a.state.params + a.state.mu, b.state.params + b.state.mu))
    del b
    # conv FLOPs of one forward at 128^2, from the layers' shapes
    conv_flops = []
    hooks = [m.register_forward_hook(lambda m, i, o: conv_flops.append(
        2 * o.numel() * m.weight[0].numel())) for m in a.model.modules()
        if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        a.model(images20[:1])
    for h in hooks:
        h.remove()
    step_tflop = 3 * INST_BATCH * sum(conv_flops) / 1e12
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.fit(INST_TIMED, fused_steps=INST_TIMED, log_every=INST_TIMED)
    torch.cuda.synchronize()
    inst_steps_s = INST_TIMED / (time.perf_counter() - t0)
    x = a.sample(a.step)
    args = [x[k] for k in ("waterfall", "inst_masks", "inst_classes", "inst_valid")]
    sample_ms = cuda_ms(lambda: a.sample(0), calls=5, windows=3)
    step_ms = cuda_ms(lambda: a._step(a.state, *args), calls=5, windows=3)
    k4_64_ms = cuda_ms(lambda: fused_extract_channels(args[0]))
    n_px = args[0].numel()
    k4_64_bound, k4_64_by = bound(n_px * (8 + 12), n_px * K4_OPS_PER_PIXEL)
    log(f"InstanceTrainer {INST_MODEL}, patch {PATCH}, batch {INST_BATCH}, float32, the "
        f"recipe's schedule (warmup {warmup}): losses " + ", ".join(
            f"{v:.4f}" for v in losses[::10].tolist()) + f" (every 10th), mean of the first "
        f"10 {float(losses[:10].mean()):.4f}, of the last 10 {float(losses[-10:].mean()):.4f};"
        f" K4 launches in the {INST_STEPS} steps {inst_train_launches}; the first {INST_CKPT} "
        f"steps (cuDNN set-up included) {first_s:.2f} s; {INST_TIMED} steps timed after: "
        f"{inst_steps_s:.2f} steps/s on {kind} (a sample batch {sample_ms:.2f} ms, a step on "
        f"it {step_ms:.2f} ms, {step_tflop:.3f} TFLOP of convs a step: "
        f"{step_tflop / step_ms * 1e3:.1f} TFLOP/s; K4 at ({INST_BATCH},{PATCH},{PATCH}) "
        f"{k4_64_ms:.4f} ms, bound {k4_64_bound:.4f} ({k4_64_by})); resumed from step "
        f"{INST_CKPT} against the uninterrupted run (deterministic cuDNN): params and Adam's "
        f"first moments at {worst:.3g} of rtol {RESUME_RTOL:g} + atol {RESUME_ATOL:g}; last "
        f"record {history[-1]}")
    require(bool(torch.isfinite(losses).all()) and len(losses) == INST_STEPS,
            "InstanceTrainer: a loss is not finite")
    require(float(losses[-10:].mean()) < float(losses[:10].mean()),
            "InstanceTrainer: the loss did not fall")
    require(inst_train_launches == INST_STEPS, "InstanceTrainer: K4 did not run once a step")
    require(worst <= 1.0, "InstanceTrainer: the resumed run differs from the uninterrupted one")

    # one float32 step of 8 on the card (K4) against the CPU (the plain
    # extraction), from the same weights on the same batch. The float32
    # gradients lie within 1e-5 of float64 in norm, and where they are that
    # close their distance is set by which max-pool and ReLU choices flip
    # (the images' 7e-7 differences alone move the card's from 7.6e-6 to
    # 2.4e-5: tools/instance_grad_float64.py), so the card's gradient is held
    # to 2x the CPU's distance or to phase 12's floor of 1e-4, whichever is
    # larger
    def fresh(device=None):
        trainer = InstanceTrainer(model=SOLOLite(**INST_MODEL), patch_size=PATCH,
                                  batch_size=INST_CHECK_BATCH, learning_rate=INST_CHECK_LR,
                                  seed=SEED, device=device)
        trainer._init()
        return trainer

    c_cpu, c_gpu, c_opt = fresh("cpu"), fresh(), fresh()
    check = c_gpu.generate_batch(torch.Generator(device=dev).manual_seed(SEED + 21))
    args_gpu = [check[k] for k in ("waterfall", "inst_masks", "inst_classes", "inst_valid")]
    args_cpu = [v.cpu() for v in args_gpu]
    start = flat(c_cpu.state.params)
    m64 = copy.deepcopy(c_cpu.model).double()
    loss64 = solo_loss(m64(fused_extract_channels_plain(args_cpu[0]).double()), *args_cpu[1:])[0]
    g64 = flat(torch.autograd.grad(loss64, list(m64.parameters())))
    g_cpu, g_gpu = recorded(c_cpu.state), recorded(c_gpu.state)
    one_step = make_instance_train_step()
    reset_counts()
    l_gpu = float(one_step(c_gpu.state, *args_gpu)[1])
    require(fused_extract_channels.launches == 1, "the float32 step on the card did not run K4")
    l_cpu = float(one_step(c_cpu.state, *args_cpu)[1])
    c_opt.state.apply_gradients([g.to(dev) for g in g_cpu[0]])
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    err_cpu = float((flat(g_cpu[0]) - g64).norm() / g64.norm())
    err_gpu = float((flat(g_gpu[0]) - g64).norm() / g64.norm())
    p_cpu = flat(c_cpu.state.params)
    opt_diff = float((flat(c_opt.state.params) - p_cpu).abs().max()) / INST_CHECK_LR
    path_agree = float((((flat(c_gpu.state.params) - start) - (p_cpu - start)).abs()
                        <= OPT_ATOL_LR * INST_CHECK_LR).double().mean())
    log(f"  float32 step on {INST_CHECK_BATCH} images, card (K4) against CPU (plain): loss "
        f"{l_gpu:.6f} / {l_cpu:.6f} (float64 {float(loss64.detach()):.6f}), rel diff {rel:.2e} (tol "
        f"{F32_LOSS_RTOL:g}); gradient off float64 by {err_gpu:.3e} (card) and {err_cpu:.3e} "
        f"(CPU) in norm (card at most 2x the CPU or {GRAD_F64_FLOOR:g}); optimiser fed the "
        f"CPU's gradients: max "
        f"|param diff| {opt_diff:.2e} * lr (tol {OPT_ATOL_LR:g}); the two steps' updates agree "
        f"within {OPT_ATOL_LR:g} * lr on {path_agree:.4f} of the coordinates (not checked)")
    require(rel <= F32_LOSS_RTOL, "SOLOLite float32 step: card and CPU losses disagree")
    require(err_gpu <= max(2 * err_cpu, GRAD_F64_FLOOR),
            "SOLOLite float32 gradient: the card is far from float64")
    require(opt_diff <= OPT_ATOL_LR, "SOLOLite: the optimiser on the card disagrees with the CPU")
    del c_cpu, c_gpu, c_opt, m64, g64, g_cpu, g_gpu

    # real-patch mixing: a quarter of the batch from phase 5's 128^2 patches
    reset_counts()
    mixed = a.fit(1, log_every=1, real_patches=patches, real_fraction=0.25)["history"]
    require(np.isfinite(mixed[0]["loss"]) and fused_extract_channels.launches == 1,
            "InstanceTrainer with real patches: the loss is not finite or K4 did not run once")
    snap = a.save(inst_dir / "sololite.npz")
    loaded = InstanceTrainer.load(snap, batch_size=INST_BATCH)
    torch.backends.cudnn.deterministic = True
    try:
        mine = a.predict(images20[:n_cmp], score_thresh=0.3)
        theirs = loaded.predict(images20[:n_cmp], score_thresh=0.3)
    finally:
        torch.backends.cudnn.deterministic = False
    same = all(np.array_equal(p[k], q[k]) for p, q in zip(mine, theirs) for k in p)
    log(f"  a step with {INST_BATCH // 4} of {INST_BATCH} samples from phase 5's patches: loss "
        f"{mixed[0]['loss']:.4f}, K4 once; save -> InstanceTrainer.load -> predict equal to "
        f"the trainer's own predict: {same}")
    require(same, "InstanceTrainer: the loaded snapshot predicts otherwise than the trainer")
    del a, loaded, images20, held
    shutil.rmtree(inst_dir)
    phases["instance training"] = time.perf_counter() - t

    # -- 22-23: the measurement-set path, then BASELINE configs 5 and 1 -----------------------
    ms_launches = measurement_set_phases(kind, phases)

    # -- 24: the command-line path ----------------------------------------------------------
    t = time.perf_counter()
    cli_launches = cli_phases(kind, phases)
    phases["command line"] = time.perf_counter() - t

    # -- 25: the mesh paths at world size 1 ------------------------------------------------
    t = time.perf_counter()
    mesh_launches = parallel_phases(kind, wf)
    phases["mesh"] = time.perf_counter() - t

    log("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
        + f"; total wall time {time.perf_counter() - T_START:.1f} s")
    static_json = []
    for name, fn, src, line, err, launches in (
            ("K1", "fused_gather_extract", "channel_planes.cu", 340,
             max(k1_err.values()), train_launches["K1"]),
            ("K2", "fused_extract_channel_planes", "channel_planes.cu", 195,
             max(k2_err.values()), prep_launches["planes"]["K2"]),
            ("K3", "fused_plane_gather_transform", "plane_gather.cu", 414,
             float(max(max(v) for v in k3_diff.values())), train_launches["K3"])):
        k_ms, p_ms, bound_ms, bound_by = static_ms[name]
        static_json.append(
            {"name": fn, "route": "cuda",
             "source": f"rfi_toolbox_tpu_torch/ops/csrc/{src}",
             "replaces": f"rfi_toolbox_tpu/ops/fused_channels.py:{line}",
             "launches": launches, "max_abs_err": err, "ms": k_ms,
             "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": None})
    csrc = "rfi_toolbox_tpu_torch/ops/csrc/"
    groups_src, strips_src = csrc + "extract_groups.cu", csrc + "extract_strips.cu"
    for name, src, line, err, launches, (k_ms, p_ms, bound_ms, bound_by) in (
            ("fused_gather_extract (above 128x128: resident-group kernel)", groups_src, 340,
             max(wrap_err["K1"]["groups"].values()),
             prep_launches["auto 256"]["K1"] + prep_launches["auto 1024"]["K1"], large_ms["K1"]),
            ("fused_gather_extract (above 128x128 where no slab fits: strip K2 + K3's gather)",
             f"{strips_src} + {csrc}plane_gather.cu", 340, max(wrap_err["K1"]["strips"].values()),
             prep_launches["auto 2048"]["K1"], large_ms["K1 (2,2048,2048)"]),
            ("fused_extract_channel_planes (above 128x128: resident-group kernel)", groups_src,
             195, max(wrap_err["K2"]["groups"].values()),
             prep_launches["planes 256"]["K2"] + prep_launches["planes 1024"]["K2"],
             large_ms["K2"]),
            ("fused_extract_channel_planes (above 128x128 where no slab fits: strip kernel)",
             strips_src, 195, max(wrap_err["K2"]["strips"].values()),
             prep_launches["planes 2048"]["K2"], large_ms["K2 (2,2048,2048)"]),
            ("fused_plane_gather_transform_images (identity mode: K1's planes into the "
             "images, the main path's launches)", csrc + "plane_gather.cu", 414,
             float(max(v[2] for v in k3_diff.values() if len(v) == 3)), train_launches["K3"],
             (identity_ms, identity_plain_ms, k3_identity_bound, "bytes")),
            ("fused_plane_gather_transform (above 128)",
             csrc + "plane_gather.cu", 414, float(max(max(v) for v in k3_large_diff.values())),
             sum(prep_launches[f"{route} {side}"]["K3"] for side in (256, 1024, 2048)
                 for route in ("auto", "planes")),
             large_ms["K3"]),
            ("fused_extract_channels (above 128x128: resident-group kernel)", groups_src, 455,
             max(k4_wrap_err["groups"].values()), raw_launches + k4_large_flag_launches,
             k4_large["(32,256,256)"]),
            ("fused_extract_channels (above 128x128 where no slab fits: strip kernel)",
             strips_src, 455, max(k4_wrap_err["strips"].values()), file_path_launches,
             k4_large["(128,1024,1024)"])):
        static_json.append(
            {"name": name, "route": "cuda", "source": src,
             "replaces": f"rfi_toolbox_tpu/ops/fused_channels.py:{line}",
             "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    kernels = static_json + [
        {"name": "fused_extract_channels", "route": "cuda",
         "source": "rfi_toolbox_tpu_torch/ops/csrc/channel_planes.cu",
         "replaces": "rfi_toolbox_tpu/ops/fused_channels.py:455",
         "launches": k4_launches + universal_launches + inst_eval_launches
         + inst_train_launches + ms_launches["K4"] + cli_launches["K4"]
         + mesh_launches["K4"],
         "max_abs_err": max(k4_err.values()),
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_bound_by, "library_ms": None},
        {"name": "mad_flag_patches", "route": "cuda",
         "source": "rfi_toolbox_tpu_torch/ops/csrc/mad_flags.cu",
         "replaces": "rfi_toolbox_tpu/ops/mad_flags.py:132",
         "launches": k5_launches + ms_launches["K5"] + mesh_launches["K5"],
         "max_abs_err": float(max(k5_diff.values())),
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound * 1e3,
         "bound_by": "bytes", "library_ms": None},
    ]
    for name, src, line, rows, total, launches in (
            ("conv3x3_call", "conv3x3.cu", "conv3x3.py:113", k6a_rows, k6a, k6a_launches),
            ("conv3x3_dw", "conv3x3.cu", "conv3x3.py:164", k6b_rows, k6b, k6b_launches),
            ("double_conv_gn_relu", "double_conv_gn.cu", "fused_doubleconv.py:156", k7_rows,
             k7, k7_launches)):
        kernels.append(
            {"name": name, "route": "cuda", "source": f"rfi_toolbox_tpu_torch/ops/csrc/{src}",
             "replaces": f"rfi_toolbox_tpu/ops/{line}", "launches": launches,
             "max_abs_err": max(r["err_abs"] for r in rows), **total})
    print(json.dumps({"layers": {"conv3x3_call": k6a_rows, "conv3x3_dw": k6b_rows,
                                 "double_conv_gn_relu": k7_rows}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
