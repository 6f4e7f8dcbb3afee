#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py                    # the whole run, as below
    python3 chip_smoke.py --kernels-only     # phases 1-3
    python3 chip_smoke.py --kernels-only --kernel raster_select
                                             # phases 1-3, one kernel's check
                                             # (also flash_attention,
                                             # flash_fwd, segment_sum)
    python3 chip_smoke.py --profile OUT_DIR  # the whole run, then a profile
    python3 chip_smoke.py --ab A.cu B.cu     # kernel sources timed in turns
    python3 chip_smoke.py --time-fits        # NeRF and mesh fit chunks and
                                             # a render-all, timed
    python3 chip_smoke.py --time-retex       # retex requests timed, one
                                             # with its segment sums traced

from the root of a checkout. It builds the hand-written kernels from
`mvedit_tpu_torch/csrc/`, holds each against its plain PyTorch version at
the shapes the main path gives it, then drives the port at full width with
seeded random weights: the SD1.5 denoise, the DMTet mesh phase, whole
`run_3d_to_3d` requests, checkpoint loading, whole `run_retex`
requests with IP-Adapter, texture superres with an orbit video, whole
image-to-3D requests (v1.1, and v1.2 with its generated normals), SAM,
legacy Zero123, the unstructured tet grid, whole text-to-3D requests
(direct and through the JSON server), the hash-grid field, SSDNeRF
training through its CLIs (the cars recipe, StableSSDNeRF's LoRA recipe
and the paper family), the module-only ports (Inception, DDPMUNet,
UNetVolume, the sparse-volume interpolation), GRM with the gaussian
renderer, TSDF fusion with marching cubes, and the view / ray sharding
over a 1-rank NCCL group.

1. device: the card's name and power limit (nvidia-smi); the stand-in
   tokenizer's ids of the smoke's prompts in two fresh processes with
   other `PYTHONHASHSEED`s equal to this process's;
2. build: nvcc of every kernel source, all started together, with ptxas'
   report;
3. kernels against their plain versions, timed with CUDA events:
   flash attention (bf16) at every path shape (superres's joint
   attention over 8 views included); the raster selection at the
   fit's, `load_init_mesh`'s, the render-size ramp's, the UV bake's and
   (32 x 32 tiles) texture superres's 2048^2 bake's configs, timed as
   single launches, in batches of 20 launched from the
   host and in batches of 20 replayed from a CUDA graph (the device's
   time alone), with its live
   candidates per tile and pixel tests per pixel, then at the GPU tests'
   edge cases (`tests/torch_raster_cases.py`; winners, face ids and key
   bits must equal the plain version's); the JAX package's own flash
   kernel API (`ops/flash_attention.py`); the fixed-order segment sum at
   the path's shapes (the dense grid's corner gathers at a NeRF chunk's
   sample count and at the retex and superres albedo fits, the mesh fit's
   vertex sums, a render's corner gather, the hash grid's levels 0 and 11
   at a NeRF step's samples, SSDNeRF training's code gradient at a step's
   own targets: the SRN rig's rays, 96 samples each, 3 planes x 4
   corners into 4 x 3 x 40 x 40 texels of 12 f32; in the LoRA recipe 8
   scenes x a 32^2 patch into 8 x 3 x 40 x 40 texels of 4; in the paper
   family 8 x 4096 rays into 8 x 3 x 128 x 128 texels of 6) and at a
   NeRF-fit step's own sample points
   (rays of the rig, those that miss the box included): the same bits on
   two runs, the bits of its order rebuilt in plain PyTorch, the bf16
   output the f32 sum rounded once, and within the rounding of that order
   of a float64 sum, timed whole, replayed from a CUDA graph, ordering
   alone and sums alone; LPIPS in bf16 against
   f32 (within 5e-2). Beside each time: the bound computed from the call's
   inputs (bytes at 3.35 TB/s or operations: 989 bf16 / 67 f32 TFLOP/s
   and, for attention, 3.9e12 exponentials/s, the exp floor) and, for
   attention, one `scaled_dot_product_attention` call as the library
   yardstick, and for the segment sum one `index_add_` (timed here only;
   the port calls neither);
4. `run_text_to_img`: two 512^2 requests (8 DPM-Solver++ steps each);
5. the MVEdit 2-pass reference-pair denoise timestep at 6 views x 512^2,
   three timesteps, with the decoded x0 images standing in for the 3D
   renders as tile and depth hints;
6. the DMTet mesh phase at the `run_3d_to_3d` defaults (tet 128, 512^2):
   `load_init_mesh` renders a seeded torus-knot mesh (~250k faces) at 32
   views, the switch to DMTet from a seeded dense field, 16 fit steps (two
   topology refreshes; the pipeline's first DMTet fit runs 120, cut to
   keep the smoke short), and the re-render of 16 views with their depth
   maps;
7. `run_3d_to_3d`, twice, at full width: SD1.5 UNet / ControlNets / VAE /
   CLIP, 512^2 renders, 32 views pruned 32 -> 16 -> 9, the dense field
   (32, 160), tet 128, LPIPS (VGG16) and the SRVGG enhancer (64 features,
   32 convs), on the torus knot written to a GLB. Cut in depth only:
   steps 8 (of 24), init_inverse_steps 32 (of 256), n_inverse_steps 16
   (of 80), tet_init_inverse_steps 24 (of 120). The warm request's wall
   time, phase times (`utils.profiling.PhaseTimer`) and peak memory are
   printed; the raster kernel's launches are counted in `load_init_mesh`,
   the mesh fit, the re-render and the bake, each on its own; the cold
   and the warm request share one seed, and their GLBs' vertices, faces
   and albedo must be bit-equal;
8. tet 256 on the request's fitted field: the switch, 8 fit steps (of
   120), then the bake with `mesh_reduction` 0.5: QEM decimation, 4 steps
   (of 24) of texture refinement, the UV bake;
9. checkpoint loading: the runner's seeded SRVGG enhancer and a full-size
   ControlNet written as `.safetensors` (by hand: the port reads them
   without the package) and as `.bin` into a temporary `checkpoint_dir`,
   loaded by a second runner of another seed: equal outputs on the card;
10. `run_retex` at full width, twice with one seed: SD1.5 with tile +
   depth ControlNets, 2-pass, LPIPS, the dense field (32, 160), 12 views
   plus the top view (`front_view_id=0`), 512^2, a seeded 512^2 `in_image`
   through IP-Adapter (the vision tower at `CLIPVisionConfig()` widths);
   the defaults' depth (steps 12 at strength 0.7: 9 timesteps,
   n_inverse_steps 24); the two albedos must be bit-equal, and flash
   attention, the raster selection and the segment sum must each launch;
11. texture superres at full width, on phase 10's GLB (the knot with its
   1024^2 albedo, so the init views come from the atlas through
   `_sample_level` and IP-Adapter prompts each view with its own): two
   `run_texture_superres` requests of one seed at the endpoint's defaults
   (no cut in depth: 6 + 2 views of 512^2, 24 steps at strength 0.4, the
   2-pass denoise at 2N = 16, 512 fit steps with LPIPS, the 2048^2 bake at
   32 x 32 raster tiles, K 64 + 32, whose overflowing tiles are counted
   and printed), whose albedos must be bit-equal and finite; one
   `run_retex(..., superres=True)` at phase 10's settings (the live field
   handed over); one `run_mesh_to_video` of the superres GLB (24 frames,
   finite, the file written). Wall time, phase times and peak memory of
   each; flash attention, the raster selection (tile 32 counted apart: at
   least one launch a request) and the segment sum must each launch;
12. image-to-3D at full width, twice with one seed: `run_zero123plus_to_mesh`
   (v1.1) on the knot rendered by the port at the front pose (512^2 on
   white): Zero123++ at its 40 steps and 960 x 640 grid with reference
   attention (flash at (2, 9600, 8, 40) for the write pass and Lk 19200
   for the read pass, both in phase 3's cases), TRACER-B7 at 640^2 on the
   initial views and every step's, DPT-hybrid at 384^2, LoFTR (4 layers)
   at 256^2 and the elevation solve (or the front pose under 8 matches),
   IP-Adapter, LPIPS and SRVGG; cut in depth only: 2 of 6 passes (1 + 12
   views) and phase 7's cuts (init_inverse_steps 32 of 640). Per-call
   times of the Zero123++ passes, segmentation, normals and pose, the
   MVEdit phases, peak memory, the pose route and LoFTR's match count;
   flash launches at both new shapes must be > 0, nothing staged, and the
   two requests' views and GLBs bit-equal;
13. image-to-3D v1.2 with its generated normals at full width, twice with
   one seed: `run_zero123plus1_2_to_mesh` on phase 12's input, each
   Zero123++ pass followed by its normal pass (a second SD1.5 UNet and
   the normal ControlNet on the RGB grid, 40 steps, 960 x 640), each
   generated view matted by `zero123plus_postprocess` and supervised by
   its normals; phase 12's cuts in depth only. Wall per request and per
   call (RGB pass, normal pass, postprocess, TRACER, DPT, LoFTR), the
   MVEdit phases, peak memory, the flash / raster / segment-sum
   launches; every flash shape in phase 3's cases; the two requests'
   views, normals and GLBs bit-equal;
14. SAM ViT-H (f32) through `run_segmentation(use_sam=True, bg_color=
   (1, 1, 1), erosion=2)` on phase 12's input view and 4 of the knot's
   512^2 renders, twice: one SAM call per view, bit-equal masks; wall per
   image and peak memory;
15. legacy Zero123 at SD1.5 widths (a seeded 8-channel UNet, CLIP
   ViT-L/14 with a 768 projection, the SD VAE), 256^2, 50 DDIM steps,
   twice with one seed: finite, bit-equal;
16. the unstructured tet grid at tet 128 on phase 7's fitted field:
   `build_grid_tets` on the host cold and cached, the switch with
   `structured_tets=False`, 8 fit steps (of 120) through
   `marching_tets_compact` and the extraction: a finite loss history,
   raster and segment-sum launches > 0, the counts against the caps;
17. text-to-3D at full width: `run_stablessdnerf` twice with one seed (50
   DPM-Solver++ steps of the SSDNeRF cars denoiser on the (1, 3, 12, 40,
   40) code, seeded weights, the 160^2 preview): code and preview
   bit-equal; then `run_stablessdnerf_to_mesh` twice with one seed, once
   called directly and once POSTed to the port's `ApiServer` on
   127.0.0.1 as `text_to_3d_stablessdnerf_to_mesh`: the distillation at
   its 200 steps, 32 views rendered from the triplane at 512^2, 2-pass,
   tet 128, the MVEdit loop cut in depth as phase 7's (steps 8 of 24,
   init_inverse_steps 32 of 256, n_inverse_steps 16 of 80); the two GLBs
   byte-equal with faces > 0; wall, parts (the code sample, the preview,
   the distillation, the init renders, then the pipeline's phases) and
   peak memory of each; flash, raster and segment-sum launches > 0 a
   request, nothing staged;
18. the hash-grid field at `_mvedit_cfg`'s hash widths (12 levels of
   2^19 rows, base 16, max 320): one 8-step NeRF-fit chunk at 256^2 on
   phase 7's rig and targets, twice from one seed (table and MLP
   bit-equal), its wall beside the dense field's chunk and its
   segment-sum launches; `triplane_ingp_point_decode` forward and
   backward on 2^18 points at the default `TriPlaneINGPConfig`, twice,
   bit-equal;
19. SSDNeRF training at the cars recipe's widths (`mvedit_tpu_torch/
   configs/ssdnerf_cars.py`: 4 scenes x 4096 rays x 96 samples a step, a
   (3, 12, 40, 40) code, the 36 -> 64 decoder, the 128-wide
   `LatentDenoiser` with EMA, code Adam 0.04, decoder Adam 1e-3, denoiser
   AdamW 1e-4) on a seeded dataset in SRN's layout (8 scenes x 50 views
   of 128^2, focal 131.25, cameras on a sphere of radius 1.3; the knot
   drawn by the port's renderer on white), cut in depth (16 of 40000
   iterations) and scene count (8 of 2458): `tools/train_ssdnerf.py`'s
   `main` in-process twice from one seed (cache, decoder, denoiser, their
   optimizer states and the EMA bit-equal; finite losses, the render loss
   falling; the step's median time with the loader's apart, peak memory,
   segment-sum launches a step), a 2-step stage-1 run and a 2-step stage-2
   warm start from its cache, a resume of the first run with the eval
   hook, and `tools/test_ssdnerf.py --recons-views 1` on 2 scenes
   (val_optim's wall time, PSNR and SSIM printed);
20. StableSSDNeRF training at full width (`mvedit_tpu_torch/configs/
   stablessdnerf_cars_lpips.py`: the seeded SD2.1 UNet frozen, f32
   weights and bf16 compute, a rank-32 LoRA on every attention
   projection, the 1024-wide 23-layer CLIP on a seeded captions pickle, 8
   scenes x one 32 x 32 patch x 96 samples, LPIPS 1.2) on phase 19's
   dataset, cut in depth (6 of 100000 steps): `tools/train_ssdnerf.py`'s
   `main` (what `python -m` runs) twice from one seed; the step and loader
   medians, peak memory, the LoRA's parameter count and the render loss a
   step; the state holds the LoRA alone, the frozen base is bit-equal to
   its initial value, and the two runs are bit-equal (LoRA, codes,
   decoder, optimizer states, EMA); then `tools/test_ssdnerf.py
   --recons-views 1` on one scene (25 of 100 val_optim steps);
21. the paper family at its (3, 6, 128, 128) code on phase 19's 8 scenes
   (8 scenes x 4096 rays x 96 samples a step, 4 steps each):
   `stage1_cars_recons16v_16bit_filesystem`, `ssdnerf_cars_recons1v`
   (stack, twice from one seed: bit-equal) and
   `ssdnerf_cars_recons1v_tiled` (ch 80, 16 groups); step and loader
   medians, peak memory;
22. the module-only ports on the card at their default widths, each held
   to the same module on the CPU in f32 (TF32 off on the card for the
   comparison): `InceptionV3Features` on 32 images of 299^2 (8 compared)
   and `inception_stat` over phase 19's dataset; `DDPMUNet(DDPMUNetConfig
   ())` forward and backward on a (2, 3, 12, 40, 40) code; `UNetVolume`
   at its SD widths on a masked 32^3 volume and the masked
   `ResnetBlockVolume(320)`; `spvolume_linear_interp` and
   `neighbor_spvolume_linear_interp` on a 64^3 volume ~40% active (~10^5
   voxels) at 2^20 points, with the gradients to the features and the
   points. Wall time each; any non-finite output fails.
23. GRM and the gaussian renderer at full width: seeded `GRMConfig()`
   (dim 512, depth 12, heads 8, patch 8; no GRM checkpoint exists) on 4
   views of 512^2 of the knot (its normals, from a rig at distance 2.5)
   with their Plücker rays: 16384 tokens in one flash attention a block
   at (1, 16384, 8, 64), 2^20 gaussians from the upsampler; each view
   rendered at `GSRasterConfig(512, 512)` (tile 16, K 256) and 8 Adam
   steps on the gaussians' attributes against the views (encoder and
   upsampler under no_grad), twice from one seed: renders, attributes and
   the first step's gradients bit-equal; flash launches at GRM's shape
   and segment-sum launches (one a render backward) > 0, nothing staged;
   wall time of the encoder, the upsampler, one render forward and
   backward, and the fit's peak memory;
24. TSDF fusion: 32 RGB-D views of 512^2 of the knot (camera-space z, 0
   off the knot) into `tsdf_rgbd_to_mesh` at its defaults (voxel 256,
   prune 800, reduction 0.2), twice: bit-equal meshes with faces, the
   median vertex distance to the knot at most 2 voxels; integration on
   the card and extraction on the host timed apart; then
   `extract_geometry` of phase 7's fitted field at 128, threshold 10;
25. sharding at world size 1 over NCCL (the card is one GPU): the
   sharded CFG step on 2 x 6 views of 512^2 at SD1.5 widths, the sharded
   NeRF step on phase 7's field and a sharded 4-step mesh-fit chunk, each
   bit-equal to its unsharded counterpart; one `run_3d_to_3d` at phase
   7's settings and seed with the runner's `device_mesh` set, whose views
   and GLB must be phase 7's first request's; wall times beside phase
   7's;
26. the last slice: (a) `apis/viewer.py::MeshViewer` at 512^2 on phase
   7's output GLB (a coarser knot when that one overflows a raster tile
   at the viewer's default capacities), a 60-frame turntable to a
   file: the median ms a frame, raster launches equal to the frames, the
   overflowing tiles (`rasterize.tile_load`), the covered share; (b)
   `SSDNeRFViewer` on phase 17's text-to-3D sample (its code sample and
   triplane decoder): `export_vdb` at 256 (16.7M densities on the card,
   `utils/vdb.py::dumps` on the host), `export_mesh` at 128 (phase 24's
   lattice; 256 would build its lattice on the host for ~110 s) at the
   midpoint of the density's range, a screenshot, a 6-view grid and a
   short video; (c) phase 7's request again with `debug=1` (the per-step
   tiles of `utils/debug_viz.py`), cut to 2 steps for the time limit (so
   its GLB is not held to phase 7's): one PNG a view a step, the time
   spent writing them; (d) the web UI's
   adapters (`apis/webui.py::endpoint_adapters`) on the card with their
   positional contracts: `3d_preproc` on the knot, `image_segmentation`
   on phase 12's input, `mesh_to_video` on phase 11's GLB; (e) the tools,
   in-process: `convert_weights --all` over phase 9's SRVGG and tile
   ControlNet laid out under MANIFEST names (a runner of its output gives
   phase 9's outputs), `generate_tets` at 128 (cold, timed), the endpoint
   walkthrough `example_api_local --tiny` on the card, and (after phase
   22) `checkpoint_cleaner --save-inf --yes` on phase 19's work dir (one
   step left, no optimiser state).

Every phase asserts; any failure exits non-zero before the last line. The
launch counters are set to 0 before each path and read after it (the
denoise path of phases 4-5; `load_init_mesh`, the fit and the re-render in
phase 6; the request, part by part, in phase 7; the retex request in
phase 10; each request and the video in phase 11; each request in phases
12, 13 and 17; phase 16; each training run and the recons eval in phases
19-21; phases 23 and 25; the viewer's turntable, the debug request and
the adapters in phase 26; the segment sum over phases 6-26): a kernel of
a path with no launch
there fails the run, and so does an input that the flash or the raster
wrapper had to stage (copy) for its kernel. Without a CUDA device the
script exits non-zero and prints no result.

`--ab SRC...` does phase 1 and then only the A/B: edited copies of the
flash source (`phase_ab_flash`, timed at the request's shapes) or of the
raster source (`phase_ab_raster`, at RASTER_CASES), built side by side,
checked against the plain version, and timed in turns. A kernel with
another C entry, such as an earlier commit's, is timed by that tree's own
`chip_smoke.py` in the same call.

`--time-fits` does phase 1 and then only times a warm NeRF-fit chunk, a
render-all and a warm mesh-fit chunk of the `mvedit_tpu_torch` beside the
script. To time an earlier commit, unpack it into a directory of the
checkout that `.gitignore` lists, copy this script into it and run that
copy in the same call.

`--time-retex` does phase 1 and then only three `run_retex` requests of
the `mvedit_tpu_torch` beside the script (cold and warm timed, the third
under `torch.profiler` with every segment sum on a stream of its own:
the device time of that stream's kernels); with `--time-fits`, both. An
earlier commit's package is timed the same way as with `--time-fits`.

`--profile OUT_DIR` then runs `torch.profiler` over one warm
`run_text_to_img` request, two warm denoise timesteps, two warm mesh-fit
chunks and two warm NeRF-fit chunks at 256^2, reads the trace
kernel by kernel (device busy share, time per pipeline range, per kernel
family, top kernels), prints the breakdown and writes it, with the gzipped
chrome traces, to OUT_DIR.
"""
import argparse
import dataclasses
import gzip
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
NUM_VIEWS = 6
SIZE = 512
STEPS_T2I = 8
DENOISE_STEPS = 24     # the schedule the pipeline's timesteps come from
DENOISE_RUN = 3        # timesteps driven here
GS, TILE_W, DEPTH_W = 7.0, 1.0, 0.5   # MVEdit3DConfig's defaults
# ((B, L, H, D), q/k scale) of the kernel's calls on the path at 512^2,
# plus the other head-dim instantiations and ragged lengths. Scale 1 is
# N(0,1) q and k (nearly uniform attention; these cases are also timed),
# scale 2 a peaked softmax. The tolerance is `agreement`'s, relative to the
# reference's magnitude.
KERNEL_CASES = [
    ((6, 8192, 8, 40), 1.0),    # reference pairs, level 1 (2 x 4096 tokens)
    ((6, 4096, 8, 40), 1.0),    # uncond views, level 1
    ((12, 4096, 8, 40), 1.0),   # ControlNets on the CFG batch, level 1
    ((2, 4096, 8, 40), 1.0),    # run_text_to_img's CFG batch, level 1
    ((6, 2048, 8, 80), 1.0),    # reference pairs, level 2
    ((2, 24576, 8, 40), 1.0),   # 6-view joint attention (use_reference=False)
    ((2, 4096, 8, 64), 1.0),
    ((1, 2048, 4, 128), 1.0),
    ((1, 1000, 8, 40), 1.0),    # ragged: not on the path, on the wrapper
    ((2, 200, 8, 40), 1.0),     # ragged, 56 of the last tile's keys masked
    ((6, 8192, 8, 40), 2.0),
    ((6, 2048, 8, 80), 2.0),
    ((2, 200, 8, 40), 2.0),
    ((8, 4096, 8, 40), 4.0),    # a very peaked softmax at a path shape
]
# run_3d_to_3d's calls (1-pass, reference pairs, diff_bs 8 view chunks)
REQUEST_SHAPES = [(8, 8192, 8, 40),    # reference pairs, level 1
                  (8, 4096, 8, 40),    # uncond views, level 1
                  (16, 4096, 8, 40),   # ControlNets on the CFG chunk, level 1
                  (8, 2048, 8, 80)]    # reference pairs, level 2
KERNEL_CASES += [(shape, 1.0) for shape in REQUEST_SHAPES]
# texture superres: the UNet's joint attention over all 8 views of the
# CFG batch at once (2N = 16 as 2 x 8 views), levels 1 and 2
KERNEL_CASES += [((2, 32768, 8, 40), 1.0), ((2, 8192, 8, 80), 1.0)]
# Zero123++'s level-0 self-attention at its 960 x 640 grid, as
# ((B, Lq, H, D), Lk): the write pass (Lk = Lq = 9600) and the read pass,
# whose keys add the conditioning image's stored states (Lk = 19200)
Z123_CASES = [(2, 9600, 8, 40), ((2, 9600, 8, 40), 19200)]
KERNEL_CASES += [(shape, 1.0) for shape in Z123_CASES]
# GRM's encoder at GRMConfig(): 4 views of 512^2 at patch 8 in one
# sequence; and the 6-view joint attention's level 2 of the sharded CFG
# step (phase 25; its level 1 is (2, 24576, 8, 40) above)
GRM_SHAPE = (1, 16384, 8, 64)
KERNEL_CASES += [(GRM_SHAPE, 1.0), ((2, 6144, 8, 80), 1.0)]
# the shape whose times go into the JSON line: the request's hottest
HOT_SHAPE = (8, 8192, 8, 40)
# --ab: small ragged cases ((B, Lq, H, D), Lk) checked before the timing,
# and launches per CUDA-event pair when timing
AB_CASES = [((2, 1000, 2, 40), 1000), ((1, 4096, 2, 40), 1152),
            ((1, 512, 2, 80), 512), ((1, 512, 2, 128), 512),
            ((1, 384, 2, 8), 384)]
AB_BATCH = 20
# raster selection: (case, size, span, k_per_tile, k_big, mesh, tile), the
# configs the path gives the kernel: the mesh fit and re-render
# (`_mesh_raster_cfg`), `load_init_mesh` and retex's frozen-mesh renders
# (the default RasterConfig), the render-size ramp, the UV bake
# (`_extract_and_bake` and retex: the grid atlas of the surface at 1024^2,
# tile 16) and texture superres's bake (2048^2, tile 32)
RASTER_CASES = [("fit", 512, 2, 1024, 64, "dmtet", 16),
                ("load_init_mesh", 512, 4, 256, 64, "knot", 16),
                ("ramp_256", 256, 2, 256, 64, "dmtet", 16),
                ("ramp_128", 128, 2, 256, 64, "dmtet", 16),
                ("bake", 1024, 4, 64, 32, "atlas", 16),
                ("superres_bake", 2048, 4, 64, 32, "atlas", 32)]
RASTER_HOT = "fit"
# the fixed-order segment sum: (case, rows, contributions, channels,
# dtype), the path's shapes: the dense grid's (32, 160) levels, gathered
# for all 8 corners at once, at a NeRF chunk's sample count (16384 rays of
# 128 samples, the 256^2 fit's patch), and the mesh fit's vertex sums at
# tet 128 (~100k vertices, ~200k faces: the gathers' backward of 3 F
# corners, the normal and Laplacian sums of 3 F and 6 F) and a render's
# corner gather of the packed xyz + normal (the background's pixels all on
# one dummy face: one row of ~180k), and retex's albedo fit (6 views of
# 512^2 a step, every pixel a point on the surface or, for the background,
# on one point: rows of thousands at level 0, ~10^6 on the background's
# 8), and texture superres's albedo fit (4 views of 512^2 a step, targets
# of the same kind)
SEGMENT_CASES = [("grid_level1", 161 ** 3, 16384 * 128 * 8, 8, "bf16"),
                 ("grid_level0", 33 ** 3, 16384 * 128 * 8, 8, "bf16"),
                 ("mesh_gather", 100000, 3 * 200000, 3, "f32"),
                 ("mesh_laplacian", 100000, 6 * 200000, 4, "f32"),
                 ("render_gather", 180000, 512 * 512, 6, "f32"),
                 ("retex_level0", 33 ** 3, 6 * 512 * 512 * 8, 8, "bf16"),
                 ("retex_level1", 161 ** 3, 6 * 512 * 512 * 8, 8, "bf16"),
                 ("superres_level0", 33 ** 3, 4 * 512 * 512 * 8, 8, "bf16"),
                 ("superres_level1", 161 ** 3, 4 * 512 * 512 * 8, 8,
                  "bf16")]
# the path's own targets: a NeRF-fit step's 16384 x 128 samples at the
# dense grid's level 1 (161^3 rows), from the rig's rays (those that miss
# the box clipped to its faces, as the grid clips them)
SEGMENT_PATH_CASE = ("nerf_chunk_level1", 161 ** 3, 16384 * 128 * 8, 8,
                     "bf16")
# the hash grid's backward at the same samples, one level a call (2^19
# rows of 2 f32): level 0 (17^3 rows linearly indexed: long rows, the
# slices' tier) and level 11 (res 320, hashed)
SEGMENT_CASES += [("hash_level0", 1 << 19, 16384 * 128 * 8, 2, "f32"),
                  ("hash_level11", 1 << 19, 16384 * 128 * 8, 2, "f32")]
# text-to-3D's distillation, 400 sums a request (2 levels x 200 steps):
# 65536 points uniform in the triplane's box, 8 corners each, into the
# MVEdit field's dense grid (the box fills the middle half of the field's
# on each axis: most rows take nothing)
SEGMENT_CASES += [("distill_level0", 33 ** 3, 65536 * 8, 8, "bf16"),
                  ("distill_level1", 161 ** 3, 65536 * 8, 8, "bf16")]
# SSDNeRF training's code gradient, one a step: 4 scenes x 4096 rays x 96
# samples x 3 planes x 4 corners into the batch's (4, 3, 40, 40) code
# texels, 12 f32 channels (the targets from `triplane_grad_targets`)
SEGMENT_CASES += [("triplane_grad", 4 * 3 * 40 * 40, 4 * 4096 * 96 * 3 * 4,
                   12, "f32")]
# the same sum in the StableSSDNeRF recipe (8 scenes x one 32 x 32 patch x
# 96 samples into (8, 3, 40, 40) texels of 4 f32) and in the paper family
# (8 scenes x 4096 rays x 96 samples into (8, 3, 128, 128) texels of 6)
SEGMENT_CASES += [("triplane_grad_lora", 8 * 3 * 40 * 40,
                   8 * 1024 * 96 * 3 * 4, 4, "f32"),
                  ("triplane_grad_paper", 8 * 3 * 128 * 128,
                   8 * 4096 * 96 * 3 * 4, 6, "f32")]
# the gaussian renderer's backward (phase 23): its candidate gathers'
# gradient, 1024 tiles x 256 candidates of 2^20 gaussians into the (N, 10)
# attribute table
SEGMENT_CASES += [("gaussian_backward", 1 << 20, 1024 * 256, 10, "f32")]
SEGMENT_HOT = "grid_level1"
# the JAX package's own flash API on (BH, L, D): (shape, sm_scale)
FWD_CASES = [((48, 8192, 40), 0.1), ((16, 4096, 64), None)]
FWD_HOT = (48, 8192, 40)
# the mesh phase at the run_3d_to_3d defaults
MESH_VIEWS = 32              # the rig of run_3d_to_3d
RERENDER_VIEWS = 16          # the mid view bucket
TET = 128
FIT_STEPS = 16               # of tet_init_inverse_steps = 120 (cut)
DENSITY_BIAS = 10.0          # log-density offset of the stand-in field
# run_3d_to_3d at full width, cut in depth (the defaults in brackets)
REQ_VIEWS = 32
REQ_STEPS = 8                # diffusion steps (24)
REQ_INIT_INV = 32            # init_inverse_steps (256)
REQ_N_INV = 16               # n_inverse_steps (80)
REQ_TET_INIT = 24            # tet_init_inverse_steps (120)
TET_BIG = 256
TET_BIG_FIT = 8              # the first fit at tet 256 (120)
REFINE_STEPS = 4             # mesh_simplify_texture_steps (24)
# image-to-3D (run_zero123plus_to_mesh, v1.1): 2 of 6 Zero123++ passes,
# the MVEdit loop cut in depth as phase 7's (init_inverse_steps of 640)
I23_PASSES = 2
I23_INPUT = 512
I23_VIEW = 320               # a view of the 960 x 640 grid
SAM_VIEWS = 4                # the knot's renders beside the input view
Z123_LEGACY_STEPS = 50       # legacy Zero123's DDIM steps (its default)
UNSTRUCT_FIT_STEPS = 8       # on the unstructured tet grid (120)
# run_retex at full width, at the endpoint's defaults
RETEX_VIEWS = 12             # + the top view of front_view_id
RETEX_STEPS = 12             # at strength 0.7: 9 timesteps
RETEX_N_INV = 24
# texture superres at the endpoint's defaults, and the orbit video
SR_ATLAS = 2048
SR_FIT_STEPS = 512
VIDEO_FRAMES = 24
LPIPS_BF16_RTOL = 5e-2       # bf16 LPIPS against f32, relative
# text-to-3D: the code sample at its 50 steps, the to-mesh request's MVEdit
# loop cut in depth as phase 7's (its tet_init_inverse_steps stay 120: the
# endpoint takes no such argument)
T23_PROMPT = "a red sports car, studio light"
T23_STEPS = 50
# the hash-grid field at `_mvedit_cfg`'s hash widths: one 8-step NeRF-fit
# chunk at 256^2, and the triplane + hash hybrid on 2^18 points
HASH_CHUNK = 8
# SSDNeRF training (phase 19): the cars recipe at its widths on a seeded
# SRN-layout dataset; cut in depth (iterations) and in the scene count
TRAIN_SCENES = 8             # of SRN cars' 2458 training scenes
TRAIN_VIEWS = 50             # SRN cars' views a scene
TRAIN_SIZE = 128             # SRN cars' images
TRAIN_FOCAL = 131.25         # SRN cars' focal length at 128^2
TRAIN_STEPS = 16             # of the recipe's 40000
TRAIN_EVAL_SCENES = 2        # test_ssdnerf's scenes (of 8)
KNOT_NU, KNOT_NV = 90, 10    # few enough faces a raster tile at 128^2
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mvedit_tpu_torch", "configs")
TRAIN_CONFIG = os.path.join(CONFIGS, "ssdnerf_cars.py")
# phases 20-21: StableSSDNeRF's LoRA recipe and the paper family at full
# width on phase 19's dataset, cut in depth (the recipes' 100000 / 80000)
LORA_STEPS = 6
LORA_RECONS_STEPS = 25       # val_optim's 100 in the recons eval
PAPER_STEPS = 4
HYBRID_POINTS = 1 << 18
RGBD_NU, RGBD_NV = 400, 48   # the knot of the RGB-D views (phases 23-24)
GRM_VIEWS = 4                # GRM's input views of 512^2
GRM_ADAM_STEPS = 8
TSDF_VIEWS = 32
TSDF_RES = 256               # tsdf_rgbd_to_mesh's voxel_resolution
EXTRACT_RES = 128            # extract_geometry's lattice on phase 7's field
VIEWER_SIZE = 512            # MeshViewer's default render size
VIEWER_FRAMES = 60           # render_turntable's default
# the knots the viewer falls back to (nu, nv) where a mesh overflows its
# default raster capacities (K 256 + 64) at 512^2
VIEWER_KNOTS = [(RGBD_NU, RGBD_NV), (200, 24), (100, 16)]
EXPORT_RES = 256             # the SSDNeRF viewer's export default
# export_mesh's lattice (256 in the viewer): at 256 the host's cold
# build of the 256^3 tet lattice took 111.7 s on the H100's host, too
# much of the smoke's time limit; 128 is phase 24's lattice, built once
# for both
EXPORT_MESH_RES = EXTRACT_RES
EXPORT_VIDEO_FRAMES = 12     # export_video (60)
TETS_TOOL_RES = 128          # generate_tets' default
# the debug request (phase 26 c), phase 7's cut further in depth for the
# smoke's time limit (phase 7's: REQ_STEPS, REQ_N_INV, REQ_TET_INIT)
DEBUG_STEPS = 2
DEBUG_N_INV = 8
DEBUG_TET_INIT = 8
SHARD_VIEWS = 6              # the sharded CFG step's views (2 x 6 images)
SHARD_FIT_STEPS = 4          # the sharded mesh-fit chunk
DEV = "cuda"
TIMED_RUNS = 10
# an H100 SXM's peaks (NVIDIA's data sheet, dense, at 700 W): bf16 tensor
# cores, f32 outside them, HBM3; and the special-function units' exp2
# (16 per clock per SM x 132 SMs x ~1.83 GHz), the exp floor of attention
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 3.9e12
R = torch.profiler.record_function   # named ranges, read by --profile


def log(*a):
    print(*a, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on the "
                 "GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_tokenizer():
    """The stand-in tokenizer's ids of the smoke's prompts (the runner
    has no vocab files, so every request tokenizes through it) in two
    fresh processes with other hash seeds equal the parent's: one prompt,
    one request, in every process."""
    from mvedit_tpu_torch.apis import parameters as P
    from mvedit_tpu_torch.models.diffusion.tokenizer import HashTokenizer
    aux = [d[k] for d in (P.nerf_mesh_defaults, P.retex_defaults)
           for k in ("aux_prompt", "aux_negative_prompt")]
    prompts = ["a red car", "a red car on a hill", "a wooden chair",
               "a wooden chair, studio light", T23_PROMPT, ""] + [
        f"a golden torus knot, studio light, {x}" for x in aux]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mvedit_tpu_torch", "models", "diffusion",
                        "tokenizer.py")
    code = ("import importlib.util, json, sys\n"
            f"spec = importlib.util.spec_from_file_location('t', {path!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "print(json.dumps(mod.HashTokenizer()(json.loads(sys.argv[1]))"
            ".tolist()))\n")
    mine = HashTokenizer()(prompts).tolist()
    for hashseed in (1, 2):
        res = subprocess.run(
            [sys.executable, "-c", code, json.dumps(prompts)],
            env=dict(os.environ, PYTHONHASHSEED=str(hashseed)),
            capture_output=True, text=True, timeout=120, check=True)
        same = json.loads(res.stdout.strip().splitlines()[-1]) == mine
        log(f"[tokenizer] {len(prompts)} prompts in a process with "
            f"PYTHONHASHSEED={hashseed}: the parent's ids {same}")
        if not same:
            raise AssertionError("the stand-in tokenizer gave other ids in "
                                 "another process")


def phase_build():
    """nvcc of every kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mvedit_tpu_torch.kernels import flash_attention as FA
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS

    def build(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0
    mods = {"flash_attention.cu": FA, "raster_select.cu": RS,
            "segment_sum.cu": SS}
    with ThreadPoolExecutor(len(mods)) as ex:
        secs = dict(zip(mods, ex.map(build, mods.values())))
    for name, mod in mods.items():
        log(f"[build] {name}: {secs[name]:.2f} s")
        with open(mod.BUILD_LOG) as f:
            for line in f:
                if "registers" in line or "spill" in line \
                        or "Compiling" in line or "C7512" in line:
                    log(f"[build]   {line.strip()}")


def plain_sliced(q, k, v, budget=4 << 30):
    """The plain version over (batch, head-group) slices whose f32 score
    tensor stays under `budget` bytes: the whole 24576^2 problem would not
    fit on the card at once."""
    from mvedit_tpu_torch.kernels.flash_attention import attention_reference
    B, Lq, H, D = q.shape
    hc = max(1, min(H, budget // (4 * Lq * k.shape[1])))
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(0, H, hc):
            out[b:b + 1, :, h:h + hc] = attention_reference(
                q[b:b + 1, :, h:h + hc], k[b:b + 1, :, h:h + hc],
                v[b:b + 1, :, h:h + hc])
    return out


def flash_bound(B, Lq, Lk, H, D):
    """Least time of one attention call on the card: the largest of its
    two kinds of operations, each at its own peak (bf16 tensor-core FLOPs
    at the real D, 4 B H Lq Lk D; the exp floor, B H Lq Lk exponentials
    on the special-function units), and its bytes (q, k, v read once, o
    written once). `op` names the operation that sets the bound."""
    mma_ms = 4.0 * B * H * Lq * Lk * D / PEAK_BF16 * 1e3
    exp_ms = B * H * Lq * Lk / PEAK_EXP * 1e3
    bytes_ms = 2.0 * B * H * D * (2 * Lq + 2 * Lk) / PEAK_BYTES * 1e3
    ops_ms = max(mma_ms, exp_ms)
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                op="exp" if exp_ms > mma_ms else "bf16 mma",
                mma_ms=mma_ms, exp_floor_ms=exp_ms)


def flash_bound_text(bd):
    by = bd["bound_by"]
    if by == "operations":
        by += f": {bd['op']}"
    return (f"bound {bd['bound_ms']:.3f} ms ({by}; tensor cores "
            f"{bd['mma_ms']:.3f} ms, exp floor {bd['exp_floor_ms']:.3f} ms)")


def library_attention(q, k, v, scale=None, batch=1):
    """Time one `scaled_dot_product_attention` call on the (B, H, L, D)
    views of (B, L, H, D) inputs: a yardstick for the flash kernel, used
    nowhere in the port. Returns (ms, the backend PyTorch chose)."""
    from torch.nn.attention import SDPBackend
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    names = {b.value: n for n, b in SDPBackend.__members__.items()}
    try:
        backend = names.get(int(torch._fused_sdp_choice(qt, kt, vt,
                                                        scale=scale)), "?")
    except (AttributeError, RuntimeError):
        backend = "unknown"
    ms = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          scale=scale),
                   batch=batch)
    return ms, backend


def raster_bound(pts, faces, tile_tris, tile_valid, big_tris, big_valid,
                 tiles_x, tile=16):
    """Least time of one raster selection on the card, counted from this
    call's data. Operations, at the f32 peak: the coefficients of each
    face that a valid slot reaches (48 flops, once per face); the reject,
    each edge at one corner of each 8 x 4 pixel block (12 flops per valid
    (tile, slot) pair and block); and only for the (pixel, candidate)
    pairs that the reject keeps, 4 flops for edge 0, 4 more for each
    further edge while the earlier ones pass, 4 for the key of a covered
    pixel. The reject (`block_masks`) is exact for the rounded tests, so
    it keeps every covered pair. Bytes, at the memory rate: the bin lists'
    masks and the ids of their valid slots, the big list's masks and
    valid ids once, the faces and vertices they reach once each, and the
    three outputs. Beside the bound, the kernel's own work: the live
    candidates per tile (mean, max) and the pixel tests per pixel its
    warps run."""
    from mvedit_tpu_torch.kernels.raster_select import (block_masks,
                                                        prepare_coeffs)
    T, P = tile_tris.shape[0], tile * tile
    dev = tile_tris.device
    cand = torch.cat([tile_tris, big_tris[None].expand(T, -1)], 1)
    cval = torch.cat([tile_valid, big_valid[None].expand(T, -1)], 1)
    K = cand.shape[1]
    pix = torch.arange(P, device=dev)
    px, py = pix % tile, pix // tile
    blk = px // 8 + (tile // 8) * (py // 4)  # the pixel's 8 x 4 block
    ids = torch.unique(torch.cat([tile_tris[tile_valid],
                                  big_tris[big_valid]]))
    flops = 48.0 * ids.numel() + (P // 32) * 12.0 * float(cval.sum())
    live, tests = [], 0.0
    step = max(1, (1 << 27) // (P * K))
    for t0 in range(0, T, step):
        t = torch.arange(t0, min(T, t0 + step), device=dev)
        co = prepare_coeffs(pts, faces, cand[t], cval[t])   # (t, K, 12)
        keep = block_masks(co, tiles_x, t, tile)             # (t, K, blocks)
        live.append(keep.any(-1).sum(-1))
        on = keep[:, :, blk].transpose(1, 2)                 # (t, P, K)
        tests += float(on.sum())
        flops += 4.0 * float(on.sum())
        qx = ((t % tiles_x) * tile)[:, None] + px + 0.5
        qy = ((t // tiles_x) * tile)[:, None] + py + 0.5
        qx, qy = qx.float()[:, :, None], qy.float()[:, :, None]   # (t, P, 1)
        for e in range(3):
            c = co[:, None, :, 3 * e:3 * e + 3]
            on = on & (c[..., 0] * qx + c[..., 1] * qy + c[..., 2] >= 0)
            flops += 4.0 * float(on.sum())
        del co, on, keep
    live = torch.cat(live).float()
    nbytes = (tile_valid.numel() + 8 * float(tile_valid.sum())
              + big_valid.numel() + 8 * float(big_valid.sum())
              + 24 * ids.numel() + 12 * torch.unique(faces[ids]).numel()
              + T * P * 16)
    ops_ms = flops / PEAK_F32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                flops=flops, nbytes=nbytes, live_mean=float(live.mean()),
                live_max=int(live.max()), tests_per_px=tests / (T * P))


def median_ms(fn, runs=TIMED_RUNS, batch=1, graph=False):
    """Median over `runs` CUDA-event pairs, each around `batch` calls of
    `fn` back to back, per call. With `graph`, the `batch` calls are
    captured once in a CUDA graph and the pairs time its replays: the
    device's time alone, where a short kernel would otherwise wait on the
    host's launches."""
    fn()
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(batch):
                fn()
        run, batch = g.replay, batch
    else:
        def run():
            for _ in range(batch):
                fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def case_dims(shape):
    """A KERNEL_CASES shape, (B, L, H, D) or ((B, Lq, H, D), Lk) ->
    ((B, Lq, H, D), Lk)."""
    if isinstance(shape[0], tuple):
        return shape
    return shape, shape[1]


def phase_kernel():
    from mvedit_tpu_torch.kernels.flash_attention import (
        MAX_REL_TOL, MEAN_REL_TOL, agreement, flash_attention)
    log(f"[kernel] bounds: max|d| <= {MAX_REL_TOL:g} * max|ref|, mean|d| <= "
        f"{MEAN_REL_TOL:g} * mean|ref|")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rows, failed, worst = [], [], 0.0
    for shape, qk in KERNEL_CASES:
        (B, L, H, D), Lk = case_dims(shape)
        q = torch.randn((B, L, H, D), generator=gen, device=DEV,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, Lk, H, D), generator=gen, device=DEV,
                            dtype=torch.bfloat16) for _ in range(2))
        q, k = q * qk, k * qk
        out = flash_attention(q, k, v)
        ref = plain_sliced(q, k, v)
        torch.cuda.synchronize()
        r = agreement(out, ref)
        line = (f"[kernel] {shape} q,k x{qk:g}: max|d| {r['max_abs']:.3e} "
                f"= {r['max_rel']:.2e} of max|ref| {r['ref_max']:.3e}; "
                f"mean|d| {r['mean_abs']:.3e} = {r['mean_rel']:.2e} of "
                f"mean|ref| {r['ref_mean']:.3e}")
        if qk == 1.0:
            ms = median_ms(lambda: flash_attention(q, k, v))
            plain_ms = median_ms(lambda: plain_sliced(q, k, v))
            lib_ms, backend = library_attention(q, k, v)
            bd = flash_bound(B, L, Lk, H, D)
            flops = 4.0 * B * H * L * Lk * D
            line += (f"; kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
                     f"at the real D) {flash_bound_text(bd)} library "
                     f"{lib_ms:.3f} ms (sdpa, {backend}) plain "
                     f"{plain_ms:.3f} ms")
            rows.append(dict(shape=shape, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, **bd))
        log(f"{line} {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failed.append((shape, qk))
        worst = max(worst, r["max_abs"])
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {failed}")
    return rows, worst


def phase_unet_route(runner):
    """One full-size UNet call (run_text_to_img's CFG batch) through the
    kernel and again through the plain version: the whole network agrees."""
    import mvedit_tpu_torch.models.diffusion.attention as TA
    m = runner.load_stable_diffusion()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    lat = torch.randn((2, SIZE // 8, SIZE // 8, 4), generator=gen,
                      device=DEV)
    pos, neg = runner.encode_prompt(m, ["a red car"], [""])
    t = torch.full((2,), 999, dtype=torch.int32, device=DEV)
    with torch.inference_mode():
        a = m.unet(lat, t, torch.cat([neg, pos], 0))
        kernel = TA.flash_attention
        TA.flash_attention = plain_sliced
        try:
            b = m.unet(lat, t, torch.cat([neg, pos], 0))
        finally:
            TA.flash_attention = kernel
    rel = ((a - b).norm() / b.norm()).item()
    log(f"[unet] kernel vs plain attention through the SD1.5 UNet at "
        f"{SIZE}^2: relative L2 {rel:.3e}")
    # a few bf16 ulps per attention layer, carried through 16 of them
    if not (torch.isfinite(a).all().item() and rel <= 3e-2):
        raise AssertionError("UNet output through the kernel disagrees")


def phase_text_to_img(runner):
    runner.load_stable_diffusion()
    for prompt, seed in (("a red car on a hill", 1),
                         ("a wooden chair, studio light", 2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = runner.run_text_to_img(prompt, seed=seed, steps=STEPS_T2I)
        wall = time.perf_counter() - t0
        ok = (img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()
              and img.min() >= 0.0 and img.max() <= 1.0)
        log(f"[text_to_img] {prompt!r} seed {seed}: {img.shape}, "
            f"mean {img.mean():.4f}, {wall:.3f} s wall "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("run_text_to_img output is malformed")


@torch.inference_mode()
def phase_denoise(runner, prof=None):
    """3 timesteps of `mvedit_3d.py:769-941` without the 3D fuse. `prof`, a
    scheduled `torch.profiler.profile`, is stepped after each timestep."""
    from mvedit_tpu_torch.models.diffusion import schedulers as S
    from mvedit_tpu_torch.pipelines.denoise import (DenoiseModels,
                                                    make_noise_pred_2pass)
    m = runner.load_stable_diffusion()
    cns = runner.load_controlnets(("tile", "depth"))
    N, dev = NUM_VIEWS, runner.device
    sch = m.schedule
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    images = torch.rand((N, SIZE, SIZE, 3), generator=gen, device=dev)
    pos, neg = runner.encode_prompt(m, ["a wooden chair"] * N, [""] * N)
    embeds = torch.cat([neg, pos], 0)
    # diff_bs (8) >= 6 views: the pipeline runs the whole-batch functions
    p1, p2 = make_noise_pred_2pass(DenoiseModels(
        unet=m.unet, controlnets=cns, num_views=N, use_reference=True))
    steps = S.make_timesteps(DENOISE_STEPS, sch.num_train_timesteps,
                             "trailing")
    lat0 = m.vae.encode(images * 2 - 1)
    # noise shared across views (mvedit_3d.py:609-619)
    noise, ref_noise = (torch.randn(lat0.shape[1:], generator=gen,
                                    device=dev).expand_as(lat0)
                        for _ in range(2))
    latents = S.add_noise(sch, lat0, noise, int(steps[0]))
    ref_noisy = S.add_noise(sch, lat0, ref_noise, int(steps[0]))
    state = ref_state = S.SolverState.init(latents)
    torch.cuda.reset_peak_memory_stats()
    for i in range(DENOISE_RUN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with R("timestep"):
            t, t_prev = int(steps[i]), int(steps[i + 1])
            t_vec = torch.full((2 * N,), t, dtype=torch.int32, device=dev)
            cfg_lat = torch.cat([latents, latents], 0)
            with R("p1"):
                eps, enc_state, p1_res = p1(cfg_lat, t_vec, embeds, None,
                                            DEPTH_W, GS, ref_noisy=ref_noisy)
            sa, sn = sch.sqrt_acp(t)
            with R("vae_decode"):
                dec = m.vae.decode((latents - sn * eps) / sa)
            dec = ((dec + 1) / 2).clamp(0, 1)
            # hints from the decoded views: tile = the images, depth = their
            # gray level as a 3-channel map
            tile, depth = dec, dec.mean(-1, keepdim=True).expand_as(dec)
            with R("vae_encode"):
                eps_3d = (latents - sa * m.vae.encode(tile * 2 - 1)) / sn
            with R("p2"):
                eps_unet = p2(cfg_lat, enc_state, p1_res, t_vec, embeds,
                              torch.cat([tile, tile], 0),
                              torch.cat([depth, depth], 0),
                              TILE_W, DEPTH_W, GS, ref_noisy=ref_noisy)
            with R("solver"):
                bw = 1.0 - sa       # blend_mode="dynamic"
                latents, state = S.dpmsolver_step(
                    sch, latents, bw * eps_3d + (1 - bw) * eps_unet, t,
                    t_prev, state)
                # the reference rows stay on schedule (mvedit_3d.py:934-941)
                ref_noisy, ref_state = S.dpmsolver_step(
                    sch, ref_noisy, (ref_noisy - sa * lat0) / sn, t, t_prev,
                    ref_state)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.step()
        ok = bool(torch.isfinite(latents).all() and torch.isfinite(dec).all()
                  and torch.isfinite(ref_noisy).all())
        log(f"[denoise] timestep {i} (t={t}): {wall:.3f} s wall, latents "
            f"std {latents.std().item():.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("non-finite values in the denoise loop")
    peak = torch.cuda.max_memory_allocated()
    log(f"[denoise] peak memory allocated: {peak / 2**30:.2f} GiB")


def torus_knot(p=2, q=3, nu=1000, nv=125, radius=0.8, tube=0.09):
    """A (p, q) torus-knot tube, seeded by nothing: (nu * nv) verts, 2 nu nv
    faces (250k at the defaults), inside the unit sphere; `vc` None."""
    import types
    t = np.linspace(0, 2 * np.pi, nu, endpoint=False)

    def curve(t):
        r = 2 + np.cos(q * t)
        return np.stack([r * np.cos(p * t), r * np.sin(p * t),
                         -np.sin(q * t)], -1) * (radius / 3)
    c, dt = curve(t), 1e-4
    tan = curve(t + dt) - curve(t - dt)
    acc = curve(t + dt) - 2 * c + curve(t - dt)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    nrm = acc - (acc * tan).sum(-1, keepdims=True) * tan
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    bnm = np.cross(tan, nrm)
    a = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    v = (c[:, None] + tube * (np.cos(a)[None, :, None] * nrm[:, None]
                              + np.sin(a)[None, :, None] * bnm[:, None]))
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    v00, v10 = i * nv + j, ((i + 1) % nu) * nv + j
    v11, v01 = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    f = np.concatenate([np.stack([v00, v10, v11], -1).reshape(-1, 3),
                        np.stack([v00, v11, v01], -1).reshape(-1, 3)])
    return types.SimpleNamespace(v=v.reshape(-1, 3).astype(np.float32),
                                 f=f.astype(np.int32), vc=None)


def _rig(size):
    from mvedit_tpu_torch.apis import cameras as C
    from mvedit_tpu_torch.utils import camera as cu
    c = C.CONSTANTS
    rng = np.random.default_rng(SEED)
    poses, intr = C.surround_rig(
        MESH_VIEWS, c["proc_3d_to_3d_camera_distance"],
        c["proc_3d_to_3d_fov"], c["proc_3d_to_3d_min_elev"],
        c["proc_3d_to_3d_max_elev"], size, rng=rng)
    lights, _ = cu.light_sampling(poses, rng=rng)
    return poses.astype(np.float32), intr, lights.astype(np.float32)


def _dmtet_surface():
    """A DMTet surface at tet 128 of a bumpy sphere: (verts, faces,
    face_mask) on the card."""
    from mvedit_tpu_torch.models.mesh import (StructuredTetGrid,
                                              marching_tets_structured)
    g = StructuredTetGrid(TET)
    v = torch.as_tensor(g.verts, device=DEV)
    sdf = 0.6 - v.norm(dim=-1) + 0.08 * torch.sin(5 * v[:, 0]) \
        * torch.cos(4 * v[:, 1]) * torch.sin(3 * v[:, 2])
    mt = marching_tets_structured(g, g.arrays(DEV), sdf,
                                  vert_cap=262144, face_cap=393216)
    return mt["verts"], mt["faces"], mt["face_mask"]


def _raster_soup(kind):
    """(verts, faces, face_mask) on the card: a DMTet surface at tet 128 of
    a bumpy sphere, the torus knot, or (kind "atlas") the per-triangle
    grid atlas of that DMTet surface as the UV bake rasterizes it (verts
    (u, v, 1), to be scaled by the atlas size). Each has 12 large
    triangles added so that the tiles' big list wins pixels too."""
    if kind == "atlas":
        from mvedit_tpu_torch.models.mesh import Mesh
        verts, faces, fmask = _dmtet_surface()
        f = faces[fmask].cpu().numpy()
        m = Mesh(v=np.zeros((int(f.max()) + 1, 3), np.float32), f=f)
        m.auto_uv()
        uv = torch.as_tensor(m.vt, device=DEV)
        verts = torch.cat([uv, torch.ones_like(uv[:, :1])], -1)
        faces = torch.as_tensor(m.ft, device=DEV).long()
        fmask = torch.ones(faces.shape[0], dtype=torch.bool, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
        ctr = torch.rand((12, 1, 2), generator=gen, device=DEV)
        big = (ctr + (torch.rand((12, 3, 2), generator=gen, device=DEV)
                      * 2 - 1) * 0.2).reshape(-1, 2)
        big_v = torch.cat([big, torch.ones_like(big[:, :1])], -1)
    else:
        if kind == "dmtet":
            verts, faces, fmask = _dmtet_surface()
        else:
            m = torus_knot()
            verts = torch.as_tensor(m.v, device=DEV)
            faces = torch.as_tensor(m.f, device=DEV).long()
            fmask = torch.ones(faces.shape[0], dtype=torch.bool, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
        # corners up to 0.6 from a centre within 0.5 of the origin: wider
        # than span tiles at every case's size, so they go to the big list
        ctr = torch.rand((12, 1, 3), generator=gen, device=DEV) - 0.5
        big_v = (ctr + (torch.rand((12, 3, 3), generator=gen, device=DEV)
                        * 2 - 1) * 0.6).reshape(-1, 3)
    big_f = torch.arange(12 * 3, device=DEV).reshape(12, 3) + verts.shape[0]
    return (torch.cat([verts, big_v]), torch.cat([faces, big_f]),
            torch.cat([fmask, torch.ones(12, dtype=torch.bool, device=DEV)]))


def _raster_inputs(verts, faces, fmask, cfg, kind):
    """The selection's inputs at `cfg` as the path builds them: pts, the
    bin lists and the big list apart (`rasterize`), and the joined list
    that `select_reference` takes."""
    from mvedit_tpu_torch.models.mesh import pose_to_w2c, project_mesh
    from mvedit_tpu_torch.models.mesh.rasterize import (_bin_triangles,
                                                        candidates)
    size = cfg.height
    if kind == "atlas":
        pts = verts * torch.tensor([size, size, 1.0], device=DEV)
    elif kind == "pixels":
        pts = verts
    else:
        poses, intr, _ = _rig(size)
        pts = project_mesh(verts, pose_to_w2c(torch.as_tensor(
            poses[0], device=DEV)), torch.as_tensor(intr[0], device=DEV))
    lists = _bin_triangles(pts, faces, fmask, cfg)
    return pts, lists, candidates(pts, faces, fmask, cfg)


def raster_agreement(out, pts, faces, cand, cval, cfg):
    """The kernel's (best, key, face) against `select_reference` on the
    joined list: pixels whose winner index or face differs, pixels whose
    key bits differ, the largest |key| difference where both cover, and
    the plain winners."""
    from mvedit_tpu_torch.kernels.raster_select import raster_select_reference
    bk, kk, fk = out
    bp, kp, fp = raster_select_reference(pts, faces, cand, cval, cfg.tile,
                                         cfg.tiles_x, cfg.cull_backface)
    mism = int(((bk != bp) | (fk != fp)).sum())
    bits = int((kk.view(torch.int32) != kp.view(torch.int32)).sum())
    both = (kk < 1e38) & (kp < 1e38)
    err = float((kk - kp).abs()[both].max()) if both.any() else 0.0
    return mism, bits, err, bp, kp


def raster_edge_cases():
    """The GPU tests' edge cases (`tests/torch_raster_cases.py`: slivers,
    pixel-centre ties, duplicates with face 0 big, full lists, an empty
    frame) at 128^2 and 256^2 (several warps per pixel block) and 512^2,
    three of them with culling, and each at 256^2 in 32 x 32 tiles:
    (name, pts, faces, mask, cfg)."""
    from mvedit_tpu_torch.models.mesh import RasterConfig
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_raster_cases import CASES
    runs = [(n, size, False, None) for n in CASES
            for size in (128, 256, 512)]
    runs += [(n, 256, True, None) for n in ("slivers", "pixel_grid",
                                            "duplicates")]
    runs += [(n, 256, False, 32) for n in CASES]
    for name, size, cull, tile in runs:
        pts, faces, fv, kw = CASES[name](2, size)
        if tile is not None:
            kw = dict(kw, tile=tile)
        yield (f"{name} {size}^2{' cull' if cull else ''}"
               f"{f' tile {tile}' if tile else ''}",
               *(torch.as_tensor(x, device=DEV) for x in (pts, faces, fv)),
               RasterConfig(cull_backface=cull, **kw))


def raster_edge_check(call, tag):
    """`call`, a wrapper of `raster_select`'s interface, against the plain
    version at `raster_edge_cases`: logs each case under `tag` and returns
    the names of those whose winners, face ids or key bits differ."""
    failed = []
    for name, pts, faces, fv, cfg in raster_edge_cases():
        pts, (tt, tv, bt, bv), (cand, cval) = _raster_inputs(
            pts, faces, fv, cfg, "pixels")
        out = call(pts, faces, tt, tv, cfg.tile, cfg.tiles_x,
                   cfg.cull_backface, bt, bv)
        mism, bits, _, _, kp = raster_agreement(out, pts, faces, cand,
                                                cval, cfg)
        ok = mism == 0 and bits == 0
        log(f"{tag} edge case {name}: {int((kp < 1e38).sum())} pixels "
            f"hit; mismatched ids {mism}, key bits {bits} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    return failed


def phase_raster_kernel():
    """The raster selection kernel against `select_reference` on the same
    candidates, at every config the path gives it (timed: single launches
    and batches of AB_BATCH) and at the GPU tests' edge cases (not timed).
    Winners, face ids and key bits must be equal."""
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh import RasterConfig
    log("[raster] bound: winners, face ids and key bits equal to the "
        "plain version's at every pixel")
    rows, failed, soups = [], [], {}
    for name, size, span, k, k_big, kind, tile in RASTER_CASES:
        if kind not in soups:
            soups[kind] = _raster_soup(kind)
        verts, faces, fmask = soups[kind]
        cfg = RasterConfig(height=size, width=size, span=span, k_per_tile=k,
                           k_big=k_big, tile=tile)
        pts, (tt, tv, bt, bv), (cand, cval) = _raster_inputs(
            verts, faces, fmask, cfg, kind)
        args = (pts, faces, tt, tv, cfg.tile, cfg.tiles_x, False, bt, bv)
        staged = RS.raster_select.staged
        out = RS.raster_select(*args)
        torch.cuda.synchronize()
        mism, bits, err, bp, kp = raster_agreement(out, pts, faces, cand,
                                                   cval, cfg)
        npx = bp.numel()
        hits = int((kp < 1e38).sum())
        big = int(((bp >= k) & (kp < 1e38)).sum())
        ms = median_ms(lambda: RS.raster_select(*args))
        batched = median_ms(lambda: RS.raster_select(*args), batch=AB_BATCH)
        graphed = median_ms(lambda: RS.raster_select(*args), batch=AB_BATCH,
                            graph=True)
        plain_ms = median_ms(lambda: RS.raster_select_reference(*args))
        bd = raster_bound(pts, faces, tt, tv, bt, bv, cfg.tiles_x, tile)
        ok = (mism == 0 and bits == 0 and hits > 0.01 * npx and big > 0
              and RS.raster_select.staged == staged)
        log(f"[raster] {name}: {size}^2, tile {tile}, span {span}, K {k} + "
            f"{k_big}, "
            f"{int(fmask.sum())} faces; {hits} of {npx} pixels hit, {big} "
            f"won from the big list; mismatched ids {mism}, key bits "
            f"{bits}; live candidates per tile {bd['live_mean']:.1f} mean, "
            f"{bd['live_max']} max (of {int(cval.sum()) / cand.shape[0]:.1f}"
            f" valid slots); pixel tests per pixel {bd['tests_per_px']:.2f};"
            f" kernel {ms:.4f} ms single, {batched:.4f} ms batched x"
            f"{AB_BATCH}, {graphed:.4f} ms graphed x{AB_BATCH} (device "
            f"only); bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
            f"{bd['flops']:.3e} f32 flops, {bd['nbytes']:.3e} bytes) "
            f"library none plain "
            f"{plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
        rows.append(dict(case=name, tile=tile, ms=ms, batched_ms=batched,
                         graphed_ms=graphed,
                         plain_ms=plain_ms, mismatched=mism, key_bits=bits,
                         key_err=err, **bd))
        if not ok:
            failed.append(name)
    del soups
    failed += raster_edge_check(RS.raster_select, "[raster]")
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"raster_select disagrees with its plain "
                             f"version at {failed}")
    return rows


def phase_flash_fwd():
    """`ops.flash_attention.flash_fwd` (the JAX package's own flash API,
    on kernel 1's CUDA source) against its plain version."""
    from mvedit_tpu_torch.kernels.flash_attention import agreement
    from mvedit_tpu_torch.ops import flash_attention as OF
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    rows, failed, worst = [], [], 0.0

    def plain(q, k, v, s, chunk=4):
        # (chunk, L, L) f32 scores at a time
        return torch.cat([OF.flash_reference(q[i:i + chunk], k[i:i + chunk],
                                             v[i:i + chunk], s)
                          for i in range(0, q.shape[0], chunk)])
    for shape, scale in FWD_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=DEV,
                               dtype=torch.bfloat16) for _ in range(3))
        s = scale if scale is not None else shape[-1] ** -0.5
        out = OF.flash_fwd(q, k, v, s)
        ref = plain(q, k, v, s)
        torch.cuda.synchronize()
        r = agreement(out, ref)
        ms = median_ms(lambda: OF.flash_fwd(q, k, v, s))
        plain_ms = median_ms(lambda: plain(q, k, v, s))
        # (BH, L, D) as (1, L, BH, D) for the library call's (B, H, L, D)
        lib_ms, backend = library_attention(
            *(t.transpose(0, 1)[None] for t in (q, k, v)), scale=s)
        BH, L, D = shape
        bd = flash_bound(1, L, L, BH, D)
        log(f"[flash_fwd] {shape} sm_scale {s:.4g}: max|d| "
            f"{r['max_abs']:.3e} = {r['max_rel']:.2e} of max|ref|; mean|d| "
            f"{r['mean_abs']:.3e} = {r['mean_rel']:.2e} of mean|ref|; kernel "
            f"{ms:.3f} ms {flash_bound_text(bd)} library {lib_ms:.3f} ms "
            f"(sdpa, {backend}) plain {plain_ms:.3f} ms "
            f"{'ok' if r['ok'] else 'FAIL'}")
        rows.append(dict(shape=shape, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **bd))
        worst = max(worst, r["max_abs"])
        if not r["ok"]:
            failed.append(shape)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"at {failed}")
    return rows, worst


def segment_bound(n, rows, C, elt, idx_elt):
    """Least time of one segment sum on the card: its bytes (the targets,
    `idx_elt` B each, and the values read once, the float32 output written
    once) at the memory rate; its adds (one per contribution and channel,
    f32) take far less."""
    nbytes = float(idx_elt) * n + n * C * elt + 4.0 * rows * C
    ops_ms = n * C / PEAK_F32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                nbytes=nbytes)


def grid_corners(x, res):
    """(M, 3) points in [0, 1] -> (8 M,) the dense grid's corner rows at
    resolution `res`, point by point (`ops/dense_grid.py`'s order)."""
    p0 = torch.floor(x * res).long()
    side = res + 1
    return torch.stack([
        ((p0[:, 0] + ox).clamp(max=res) * side
         + (p0[:, 1] + oy).clamp(max=res)) * side
        + (p0[:, 2] + oz).clamp(max=res)
        for ox in (0, 1) for oy in (0, 1) for oz in (0, 1)], 1).reshape(-1)


def nerf_chunk_points(gen, size=256, rays=16384):
    """A NeRF-fit step's sample points as the dense grid takes them: the
    rig's view whose frame has the most rays that miss the box (at 256^2,
    0-0.8% of a view's rays do), `rays` rays on a strided grid over its
    whole frame, 128 stratified samples each (`sample_rays`, no occupancy
    grid), mapped to [0, 1] and clipped as `ops/dense_grid.py` clips them.
    Returns the (rays * 128, 3) points and the share of rays that miss
    the box."""
    from mvedit_tpu_torch.models.volume_renderer import (RenderConfig,
                                                         ray_aabb,
                                                         sample_rays)
    from mvedit_tpu_torch.ops.clip import clip
    from mvedit_tpu_torch.utils.geometry import (get_ray_directions,
                                                 get_rays)
    cfg = RenderConfig()
    poses, intr, _ = _rig(size)
    poses = torch.as_tensor(poses, device=DEV)
    intr = torch.as_tensor(intr, device=DEV)
    o, d = get_rays(get_ray_directions(size, size, intr), poses, norm=True)
    near, far = ray_aabb(o, d, cfg.bound)
    view = int((far <= near).float().mean((1, 2)).argmax())
    step = size // int(round(rays ** 0.5))
    rays_o = o[view, ::step, ::step].reshape(-1, 3)
    rays_d = d[view, ::step, ::step].reshape(-1, 3)
    jitter = torch.rand((rays_o.shape[0], cfg.num_samples), generator=gen,
                        device=DEV)
    xyz = sample_rays(rays_o, rays_d, cfg, jitter)[0]
    near, far = ray_aabb(rays_o, rays_d, cfg.bound)
    x01 = clip((xyz.reshape(-1, 3) + cfg.bound) / (2 * cfg.bound), 0.0, 1.0)
    return x01, float((far <= near).float().mean())


def srn_rig(n_views, rng):
    """SRN cars' cameras: c2w poses (n, 3, 4) on a sphere of radius 1.3
    looking at the origin (azimuths uniform, elevations in [-0.2, 1.2]
    rad), focal TRAIN_FOCAL and principal point at the centre of
    TRAIN_SIZE^2 -> (poses, intrinsics (n, 4))."""
    from mvedit_tpu_torch.utils import camera as cu
    azi = rng.uniform(0, 2 * np.pi, n_views)
    elev = rng.uniform(-0.2, 1.2, n_views)
    poses = cu.get_pose_from_angles(azi, elev, 1.3)[:, :3]
    c = TRAIN_SIZE / 2
    intr = np.tile(np.array([TRAIN_FOCAL, TRAIN_FOCAL, c, c], np.float32),
                   (n_views, 1))
    return poses.astype(np.float32), intr


TRIPLANE_CASES = {"triplane_grad": ("ssdnerf_cars", SEED + 19),
                  "triplane_grad_lora": ("stablessdnerf_cars_lpips",
                                         SEED + 20),
                  "triplane_grad_paper": ("ssdnerf_cars_recons1v",
                                          SEED + 21)}


def triplane_grad_targets(name="triplane_grad"):
    """The rows of a training step's code gradient in the recipe of
    TRIPLANE_CASES[name]: its batch of scenes x its rays of the SRN rig's
    pixels (scattered, or one patch a scene in the patch recipes, as the
    loader draws them), the renderer's 96 bin-centre samples in the 0.5
    box (`sample_rays`), the planes' coordinates (`_plane_coords`) and
    their 4 corners each (`ops/grid_sample.py::corner_rows`, border
    padding) -> int32 rows into the batch's B x 3 x H x W texels."""
    from mvedit_tpu_torch.datasets.loader import pixel_rays
    from mvedit_tpu_torch.models.triplane import _plane_coords
    from mvedit_tpu_torch.models.volume_renderer import sample_rays
    from mvedit_tpu_torch.ops.grid_sample import corner_rows
    from mvedit_tpu_torch.tools.train_ssdnerf import load_config
    config, seed = TRIPLANE_CASES[name]
    mod = load_config(os.path.join(CONFIGS, config + ".py"))
    cfg = mod.ssdnerf_config
    B, R = mod.train_config["batch_size"], cfg.n_rays
    ps = mod.train_config.get("patch_size")
    rng = np.random.default_rng(seed)
    poses, intr = srn_rig(TRAIN_VIEWS, rng)
    if ps:
        vi = np.repeat(rng.integers(0, TRAIN_VIEWS, B), R)
        oy, ox = rng.integers(0, TRAIN_SIZE - ps + 1, (2, B))
        gy, gx = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
        yi = (oy[:, None] + gy.reshape(1, -1)).reshape(-1)
        xi = (ox[:, None] + gx.reshape(1, -1)).reshape(-1)
    else:
        vi = rng.integers(0, TRAIN_VIEWS, B * R)
        yi, xi = rng.integers(0, TRAIN_SIZE, (2, B * R))
    o, d = pixel_rays(poses, intr, vi, yi, xi, (TRAIN_SIZE, TRAIN_SIZE))
    xyz = sample_rays(torch.as_tensor(o, device=DEV).reshape(B, R, 3),
                      torch.as_tensor(d, device=DEV).reshape(B, R, 3),
                      cfg.render)[0]
    grid = _plane_coords(xyz.reshape(B, -1, 3), cfg.triplane).transpose(0, 1)
    idx, _ = corner_rows(grid.reshape(B * 3, -1, 2), cfg.latent_shape[2:],
                         "border", False)
    return idx.reshape(-1)


def segment_indices(name, R, n, gen):
    """The targets of a SEGMENT_CASES row (or of SEGMENT_PATH_CASE)."""
    if name.startswith(("retex", "superres")):
        # a sphere of radius 0.3 in the unit cube; the background's
        # pixels (65%) all on one point
        m = n // 8
        d = torch.randn((m, 3), generator=gen, device=DEV)
        x = 0.5 + 0.3 * d / d.norm(dim=-1, keepdim=True)
        bg = torch.rand((m, 1), generator=gen, device=DEV) < 0.65
        x = torch.where(bg, torch.full_like(x, 0.37), x)
        return grid_corners(x, round(R ** (1 / 3)) - 1), {}
    if name.startswith("distill"):
        # `distill_points` in the triplane's box, mapped to [0, 1] as
        # `ingp_point_decode` maps the field's box
        from mvedit_tpu_torch.configs.ssdnerf_cars import ssdnerf_config
        from mvedit_tpu_torch.models.fields import INGPConfig
        tb, fb = ssdnerf_config.triplane.bound, INGPConfig().bound
        u = torch.rand((n // 8, 3), generator=gen, device=DEV)
        x01 = (u * (2 * tb) - tb + fb) / (2 * fb)
        return grid_corners(x01, round(R ** (1 / 3)) - 1), {}
    if name.startswith("triplane"):
        idx = triplane_grad_targets(name)
        assert idx.shape[0] == n
        return idx, {}
    if name.startswith("nerf"):
        x, miss = nerf_chunk_points(gen)
        assert 8 * x.shape[0] == n
        return grid_corners(x, round(R ** (1 / 3)) - 1), dict(miss=miss)
    if name.startswith("hash"):
        # `ops/hash_grid.py`'s rows of one level at a NeRF step's samples
        from mvedit_tpu_torch.ops.hash_grid import (_CORNERS, HashGridConfig,
                                                    _level_index)
        x, miss = nerf_chunk_points(gen)
        assert 8 * x.shape[0] == n
        res = HashGridConfig().level_resolution(int(name[len("hash_level"):]))
        p0 = torch.floor(x * res).long()
        off = torch.tensor(_CORNERS, device=DEV)
        corners = (p0[:, None, :] + off).clamp(max=res).reshape(-1, 3)
        return _level_index(corners, res, R).to(torch.int32), dict(miss=miss)
    if name.startswith("grid"):
        # samples along rays: runs of neighbouring cells, 8 corners each
        base = torch.randint(0, R - 200, (n // 64,), generator=gen,
                             device=DEV)
        return (base[:, None] + torch.arange(64, device=DEV)).reshape(-1), {}
    idx = torch.randint(0, R, (n,), generator=gen, device=DEV)
    if name == "render_gather":
        # a 512^2 view's corner gather: the background pixels (70%)
        # all gather the dummy face's corner, row 0
        idx = torch.where(torch.rand((n,), generator=gen, device=DEV)
                          < 0.7, torch.zeros_like(idx), idx)
    return idx, {}


def segment_check(SS, idx, vals, R):
    """Two runs' bits equal, equal to `segment_sum_ordered`'s, the bf16
    output the f32 sum rounded once, every row within `rounding_bound` of
    a float64 sum. Returns (ok, max |d|, the largest share of the bound,
    the longest row, bit-equal run to run, equal to the plain order)."""
    a = SS.segment_sum(idx, vals, R)
    b = SS.segment_sum(idx, vals, R)
    h = SS.segment_sum(idx, vals, R, out_dtype=torch.bfloat16)
    same = bool(torch.equal(a, b)) and bool(torch.equal(h, a.bfloat16()))
    kernel_order = bool(torch.equal(a, SS.segment_sum_ordered(idx, vals,
                                                              R)))
    exact = SS.segment_sum_reference(idx, vals, R, torch.float64)
    bound = SS.rounding_bound(idx, vals, R)
    d = (a.double() - exact).abs()
    slack = float((d / bound.clamp(min=1e-300)).max())
    ok = same and kernel_order and bool((d <= bound).all())
    longest = int(torch.bincount(idx[(idx >= 0) & (idx < R)],
                                 minlength=R).max())
    return ok, float(d.max()), slack, longest, same, kernel_order


def phase_segment_sum():
    """The fixed-order segment sum at SEGMENT_CASES and SEGMENT_PATH_CASE
    against its plain versions: two runs give the same bits; they are the
    bits of `segment_sum_ordered` (the kernel's order in plain PyTorch:
    rows of at most LONG added in order, longer ones in slices of SLICE,
    strided partials and fixed trees); the bf16 output is the f32 sum
    rounded once; each row lies within `rounding_bound` of a float64 sum.
    Timed: the wrapper's whole call (the ordering and the sums), the
    ordering alone (keys, CUB's radix sort over the row bits, offsets),
    the sum kernels alone on a kept order, the plain version (an atomic
    float32 `index_add` into zeros), and one `index_add_` (the library
    call; the port never calls it)."""
    from mvedit_tpu_torch.kernels import segment_sum as SS
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    rows, failed, worst = [], [], 0.0
    for name, R, n, C, dt in SEGMENT_CASES + [SEGMENT_PATH_CASE]:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        idx, info = segment_indices(name, R, n, gen)
        vals = torch.randn((n, C), generator=gen, device=DEV).to(dtype)
        ok, err, slack, longest, same, kernel_order = segment_check(
            SS, idx, vals, R)
        order = SS.segment_order(idx, R)
        ms = median_ms(lambda: SS.segment_sum(idx, vals, R))
        graphed_ms = median_ms(lambda: SS.segment_sum(idx, vals, R),
                               batch=AB_BATCH, graph=True)
        order_ms = median_ms(lambda: SS.segment_order(idx, R))
        kernel_ms = median_ms(lambda: SS.launch(vals, *order, R))
        plain_ms = median_ms(lambda: SS.segment_sum_reference(idx, vals, R))
        vf = vals.float()
        lib_ms = median_ms(lambda: torch.zeros(
            (R, C), device=DEV).index_add_(0, idx, vf))
        bd = segment_bound(n, R, C, vals.element_size(), idx.element_size())
        extra = "".join(f", {k} {v:.4f}" for k, v in info.items())
        log(f"[segment_sum] {name}: {n} contributions into {R} rows x {C} "
            f"{dt}, the longest row {longest}{extra}; bit-equal run to run "
            f"{same}, to the kernel's order in plain PyTorch "
            f"{kernel_order}; max |d| to the float64 sum {err:.3e}, at most "
            f"{slack:.3f} of its rounding bound; {ms:.4f} ms (ordering + "
            f"sums; {graphed_ms:.4f} ms replayed from a CUDA graph, "
            f"the device's time alone), ordering alone {order_ms:.4f} ms, "
            f"sum kernels alone "
            f"{kernel_ms:.4f} ms; bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']}: {bd['nbytes']:.3e} bytes) library "
            f"{lib_ms:.4f} ms (index_add_) plain {plain_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        rows.append(dict(case=name, ms=ms, graphed_ms=graphed_ms,
                         order_ms=order_ms,
                         kernel_ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **bd))
        worst = max(worst, err)
        if not ok:
            failed.append(name)
        del idx, vals, order, vf
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"segment_sum disagrees with its plain version "
                             f"at {failed}")
    return rows, worst


def phase_ab_flash(sources):
    """`--ab` for flash attention: builds each flash source (an edited copy of
    `csrc/flash_attention.cu`, same C entry) with nvcc, all together;
    holds each kernel against the plain version at AB_CASES and at the
    request's shapes (first batch entry); then times them at the request's
    shapes in turns (A, B, ..., B, A), AB_BATCH launches per CUDA-event
    pair, beside the library call, with nvidia-smi's SM clock and power
    sampled over the timed loops."""
    from concurrent.futures import ThreadPoolExecutor

    from mvedit_tpu_torch.kernels import flash_attention as FA
    out = os.path.join(os.path.dirname(FA.BUILD_LOG), "ab")
    libs = [os.path.join(out, f"libflash_ab{i}.so")
            for i in range(len(sources))]
    nvlogs = [f"{lib}.nvcc.log" for lib in libs]
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(FA.compile_source, sources, libs, nvlogs))
    for src, nvlog in zip(sources, nvlogs):
        with open(nvlog) as f:
            report = f.read()
        spills = re.findall(r"(\d+) bytes spill stores", report)
        log(f"[ab] {src}: spill stores per instantiation {spills}; "
            f"serialised wgmma: {'C7512' in report}")
    libs = [FA.load_library(lib) for lib in libs]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV,
                           dtype=torch.bfloat16)
    checks = AB_CASES + [((1,) + s[1:], s[1]) for s in REQUEST_SHAPES]
    failed = []
    for (B, L, H, D), Lk in checks:
        q, k, v = randn(B, L, H, D), randn(B, Lk, H, D), randn(B, Lk, H, D)
        ref = plain_sliced(q, k, v)
        for src, lib in zip(sources, libs):
            if not FA.agreement(FA.launch(q, k, v, D ** -0.5, lib),
                                ref)["ok"]:
                failed.append((src, (B, L, H, D), Lk))
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    try:
        for shape in REQUEST_SHAPES:
            B, L, H, D = shape
            q, k, v = (randn(*shape) for _ in range(3))
            s = D ** -0.5
            times = [[] for _ in sources]
            turns = list(range(len(sources)))
            for i in turns + turns[::-1]:
                times[i].append(median_ms(
                    lambda: FA.launch(q, k, v, s, libs[i]), batch=AB_BATCH))
            lib_ms, backend = library_attention(q, k, v, batch=AB_BATCH)
            pairs = "; ".join(f"{src} {a:.4f} / {b:.4f} ms"
                              for src, (a, b) in zip(sources, times))
            log(f"[ab] {shape}: {pairs}; library {lib_ms:.4f} ms (sdpa, "
                f"{backend}); {flash_bound_text(flash_bound(B, L, L, H, D))}")
    finally:
        sampler.terminate()
        samples = [r.split(",") for r in sampler.communicate()[0].split("\n")
                   if "," in r]
    if samples:
        clocks = sorted(float(c) for c, _ in samples)
        power = [float(p) for _, p in samples]
        log(f"[ab] SM clock over the timed loops {clocks[0]:.0f}-"
            f"{clocks[-1]:.0f} MHz (median {clocks[len(clocks) // 2]:.0f}), "
            f"power {min(power):.1f}-{max(power):.1f} W, {len(samples)} "
            f"samples")
    if failed:
        raise AssertionError(f"disagreements with the plain version: "
                             f"{failed}")
    log("[ab] every source agrees with the plain version")


def phase_ab_raster(sources):
    """`--ab` for the raster selection: builds each SRC (an edited copy of
    `csrc/raster_select.cu`, same C entry) with nvcc, all together; holds
    each against the plain version at RASTER_CASES and at the edge cases
    (`raster_edge_check`), then times them in turns (A, B, ..., B, A) at
    RASTER_CASES: AB_BATCH launches replayed from a CUDA graph per
    CUDA-event pair (the kernel's device time), the same launched from the
    host, and single launches."""
    import functools
    from concurrent.futures import ThreadPoolExecutor

    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh import RasterConfig
    out = os.path.join(os.path.dirname(RS.BUILD_LOG), "ab")
    libs = [os.path.join(out, f"libraster_ab{i}.so")
            for i in range(len(sources))]
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(lambda s, lib: RS.compile_source(s, lib,
                                                     f"{lib}.nvcc.log"),
                    sources, libs))
    calls = {}
    for src, lib in zip(sources, libs):
        with open(f"{lib}.nvcc.log") as f:
            regs = re.findall(r"Used (\d+) registers", f.read())
        log(f"[ab] {src}: registers per instantiation {regs}")
        calls[src] = functools.partial(RS.launch, lib=RS.load_library(lib))
    cases, soups, failed = [], {}, []
    for name, size, span, k, k_big, kind, tile in RASTER_CASES:
        if kind not in soups:
            soups[kind] = _raster_soup(kind)
        verts, faces, fmask = soups[kind]
        cfg = RasterConfig(height=size, width=size, span=span, k_per_tile=k,
                           k_big=k_big, tile=tile)
        pts, (tt, tv, bt, bv), (cand, cval) = _raster_inputs(
            verts, faces, fmask, cfg, kind)
        args = (pts, faces, tt, tv, cfg.tile, cfg.tiles_x, False, bt, bv)
        for src, call in calls.items():
            mism, bits, _, _, _ = raster_agreement(call(*args), pts, faces,
                                                   cand, cval, cfg)
            if mism or bits:
                failed.append((src, name))
        cases.append((name, args, raster_bound(pts, faces, tt, tv, bt, bv,
                                               cfg.tiles_x, tile)))
        del cand, cval
    del soups
    for src, call in calls.items():
        failed += [(src, n) for n in raster_edge_check(call, f"[ab] {src}")]
    for name, args, bd in cases:
        turns = list(calls) + list(calls)[::-1]
        graphed = {src: [] for src in calls}
        batched = {src: [] for src in calls}
        single = {src: [] for src in calls}
        for src in turns:
            graphed[src].append(median_ms(lambda: calls[src](*args),
                                          batch=AB_BATCH, graph=True))
            batched[src].append(median_ms(lambda: calls[src](*args),
                                          batch=AB_BATCH))
            single[src].append(median_ms(lambda: calls[src](*args)))
        log(f"[ab] raster {name}: " + "; ".join(
            f"{src} graphed {' / '.join(f'{t:.4f}' for t in graphed[src])} "
            f"ms, batched {' / '.join(f'{t:.4f}' for t in batched[src])} "
            f"ms, single {' / '.join(f'{t:.4f}' for t in single[src])} ms"
            for src in calls) + f"; bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})")
    if failed:
        raise AssertionError(f"disagreements with the plain version: "
                             f"{failed}")
    log("[ab] every raster source agrees with the plain version")


def phase_mesh(runner):
    """The DMTet mesh phase of `run_3d_to_3d` at its defaults: init renders,
    the switch to DMTet, the first fit (cut to FIT_STEPS), the re-render.
    Returns the raster kernel's launches in each part."""
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.fields import INGPConfig, ingp_init
    from mvedit_tpu_torch.models.mesh_fit import mesh_caps
    from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig
    from mvedit_tpu_torch.pipelines.mvedit_3d import (MVEdit3DConfig,
                                                      MVEdit3DPipeline)
    from mvedit_tpu_torch.utils.geometry import normalize_depth
    poses, intr, lights = _rig(SIZE)
    mesh = torus_knot()
    torch.cuda.reset_peak_memory_stats()
    launches = {}

    def timed(part, fn):
        RS.raster_select.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[part] = RS.raster_select.launches
        return out, time.perf_counter() - t0

    init, wall = timed("load_init_mesh", lambda: runner.load_init_mesh(
        mesh, poses, intr, SIZE, lights))
    ok = (init["images"].shape == (MESH_VIEWS, SIZE, SIZE, 3)
          and all(bool(torch.isfinite(x).all()) for x in init.values())
          and 0.01 < float(init["masks"].mean()) < 0.9)
    log(f"[mesh] load_init_mesh: {len(mesh.f)} faces, {MESH_VIEWS} views x "
        f"{SIZE}^2 in {wall:.3f} s, mask mean "
        f"{float(init['masks'].mean()):.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("load_init_mesh output is malformed")

    # run_3d_to_3d's config: dense field (32, 160), tet 128, 512^2
    cfg = MVEdit3DConfig(num_views=MESH_VIEWS, tet_resolution=TET,
                         render_size=SIZE, ingp=INGPConfig(
                             backend="dense",
                             dense=DenseGridConfig(resolutions=(32, 160))))
    pipe = MVEdit3DPipeline(None, cfg)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    field = ingp_init(cfg.ingp, gen, DEV)
    # the pipeline switches to DMTet from a NeRF-fitted field; this seeded
    # one stands in for it. Its density is exp of the origin blob, within
    # 8% of 1, so the surface init_sdf_from_density finds (its 70th
    # percentile) lies in the blob's flat tail with |sdf| ~1e-4, and the
    # first Adam steps (2.8e-4 each) flip signs all around it (on the CPU
    # at tet 128, 179k crossings became 462k in 16 steps, over the 262144
    # cap). A log-density bias of DENSITY_BIAS scales the density by e^10,
    # so the sdf changes by ~0.06 per cell near the surface, as a fitted
    # field's does.
    with torch.no_grad():
        field["mlp"][-1]["b"][0] = DENSITY_BIAS
    (tet_grid, state, opt), wall = timed(
        "switch", lambda: pipe._init_mesh_phase(field, device=DEV))
    # the same again, warm: how much of the switch is first-use cost
    _, wall_warm = timed("switch", lambda: pipe._init_mesh_phase(
        field, device=DEV))
    log(f"[mesh] switch to DMTet (tet {TET}): {wall:.3f} s ({wall_warm:.3f} "
        f"s warm), sdf > 0 at "
        f"{float((state['sdf'] > 0).float().mean()):.4f} of the lattice")
    t = {k: torch.as_tensor(v, device=DEV) for k, v in
         (("poses", poses), ("intrinsics", intr), ("cam_lights", lights))}
    targets = {"images": init["images"], "masks": init["masks"],
               "cam_weights": torch.ones(MESH_VIEWS, device=DEV), **t}
    run, _, _ = pipe._mesh_fit_fns(tet_grid, FIT_STEPS)
    draws = run.draw(targets, gen)
    # the last step renders the first step's views: its loss is comparable
    draws[-1]["view_ids"][-1] = draws[0]["view_ids"][0]
    (state, opt, out), wall = timed("fit", lambda: run(
        state, opt, targets, sched=pipe._sched_weights(0.6, "mesh"),
        draws=draws))
    loss = out["loss"].float().cpu().numpy()
    mt = out["mt"]
    nv, nf = int(mt["n_verts"]), int(mt["n_faces"])
    vcap, fcap = mesh_caps(TET)
    ok = (np.isfinite(loss).all() and loss[-1] < loss[0]
          and 0 < nv <= vcap and 0 < nf <= fcap)
    log(f"[mesh] fit: {FIT_STEPS} steps in chunks {run.chunks} in "
        f"{wall:.3f} s = {wall / FIT_STEPS:.4f} s per step (warm-up "
        f"included); loss first {loss[0]:.5f} last {loss[-1]:.5f} (same "
        f"views); n_verts {nv} / {vcap}, n_faces {nf} / {fcap} "
        f"{'ok' if ok else 'FAIL'}")
    log(f"[mesh]   losses: {' '.join(f'{x:.4f}' for x in loss)}")
    if not ok:
        raise AssertionError("the mesh fit did not run as it should")
    # one more chunk, warm: every later fit of the pipeline (80 steps per
    # timestep) runs chunks of this program
    n_fit = launches["fit"]
    steps = cfg.fit_steps_per_program
    warm, _, _ = pipe._mesh_fit_fns(tet_grid, steps)
    (state, opt, out), wall = timed("fit", lambda: warm(
        state, opt, targets, sched=pipe._sched_weights(0.6, "mesh"),
        generator=gen))
    launches["fit"] += n_fit
    mt = out["mt"]
    ok = bool(torch.isfinite(out["loss"]).all()) \
        and int(mt["n_faces"]) <= fcap
    log(f"[mesh] fit, warm chunk: {steps} steps in {wall:.3f} s = "
        f"{wall / steps:.4f} s per step; n_faces {int(mt['n_faces'])} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the warm fit chunk failed")

    def rerender():
        r = pipe._render_chunk(state["field"], state, mt, None,
                               t["poses"][:RERENDER_VIEWS],
                               t["intrinsics"][:RERENDER_VIEWS], SIZE)
        return r, normalize_depth(r["depth"], r["alpha"])
    (r, depth), wall = timed("rerender", rerender)
    ok = (r["rgb"].shape == (RERENDER_VIEWS, SIZE, SIZE, 3)
          and depth.shape == (RERENDER_VIEWS, SIZE, SIZE)
          and all(bool(torch.isfinite(x).all()) for x in (*r.values(), depth))
          and float(r["alpha"].mean()) > 0.01)
    peak = torch.cuda.max_memory_allocated()
    log(f"[mesh] re-render: {RERENDER_VIEWS} views x {SIZE}^2 in {wall:.3f} "
        f"s, alpha mean {float(r['alpha'].mean()):.4f}, depth map mean "
        f"{float(depth.mean()):.4f} {'ok' if ok else 'FAIL'}")
    log(f"[mesh] peak memory allocated over the mesh phase: "
        f"{peak / 2**30:.2f} GiB")
    if not ok:
        raise AssertionError("the mesh re-render is malformed")
    del launches["switch"]
    log(f"[launches] raster_select: {launches['load_init_mesh']} in "
        f"load_init_mesh, {launches['fit']} in the fit, "
        f"{launches['rerender']} in the re-render")
    if min(launches.values()) == 0:
        raise AssertionError("a part of the mesh phase did not launch "
                             "raster_select")
    ctx = dict(pipe=pipe, tet_grid=tet_grid, state=state, opt=opt,
               targets=targets, gen=gen)
    return launches, ctx


def phase_lpips():
    """LPIPS with bf16 weights (the runner's cast at full size) against the
    same seeded VGG16 in f32, on 128^2 patches (the fits' patch size)."""
    from mvedit_tpu_torch.models.losses import lpips_apply, lpips_init
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    p32 = lpips_init(gen, DEV)
    p16 = {"convs": [{k: v.bfloat16() for k, v in c.items()}
                     for c in p32["convs"]],
           "lins": [v.bfloat16() for v in p32["lins"]]}
    pred, tgt = (torch.rand((4, 128, 128, 3), generator=gen, device=DEV)
                 for _ in range(2))
    d32 = float(lpips_apply(p32, pred, tgt))
    d16 = float(lpips_apply(p16, pred, tgt))
    rel = abs(d16 - d32) / d32
    ok = d32 > 0 and rel <= LPIPS_BF16_RTOL
    log(f"[lpips] bf16 {d16:.6f} against f32 {d32:.6f}: relative {rel:.3e} "
        f"(bound {LPIPS_BF16_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bf16 LPIPS is off its f32 value")


class _PartCounter:
    """Counts the raster kernel's and the segment sum's launches in named
    parts of a request by wrapping the pipeline's methods (the launches
    themselves are counted by the kernels' wrappers) and keeps the fits'
    loss histories."""

    def __init__(self, runner):
        from mvedit_tpu_torch.kernels import raster_select as RS
        from mvedit_tpu_torch.kernels import segment_sum as SS
        from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline
        self.RS, self.SS, self.P = RS, SS, MVEdit3DPipeline
        self.runner = runner
        self.parts, self.seg_parts, self.losses = {}, {}, []
        self._saved = []

    def _count(self, part, fn):
        def wrapped(*a, **k):
            before = self.RS.raster_select.launches
            seg = self.SS.segment_sum.launches
            try:
                return fn(*a, **k)
            finally:
                self.parts[part] = self.parts.get(part, 0) + (
                    self.RS.raster_select.launches - before)
                self.seg_parts[part] = self.seg_parts.get(part, 0) + (
                    self.SS.segment_sum.launches - seg)
        return wrapped

    def _patch(self, obj, name, new):
        self._saved.append((obj, name, obj.__dict__.get(name)))
        setattr(obj, name, new)

    def __enter__(self):
        P, cnt = self.P, self

        def fit_fns(name, part):
            orig = getattr(P, name)

            def method(pipe, *a, **k):
                run, *rest = orig(pipe, *a, **k)

                def run2(*ra, **rk):
                    out = cnt._count(part, run)(*ra, **rk)
                    cnt.losses.append(out[-1]["loss"])
                    return out
                run2.__dict__.update(run.__dict__)
                return (run2, *rest)
            return method
        self._patch(P, "_nerf_fit_fns", fit_fns("_nerf_fit_fns", "nerf_fit"))
        self._patch(P, "_mesh_fit_fns", fit_fns("_mesh_fit_fns", "mesh_fit"))
        for name, part in (("_render_all", "render_all"),
                           ("_extract_and_bake", "bake")):
            orig = getattr(P, name)
            self._patch(P, name, (lambda o, pt: lambda pipe, *a, **k:
                                  self._count(pt, o)(pipe, *a, **k))(
                                      orig, part))
        self._patch(self.runner, "load_init_mesh", self._count(
            "load_init_mesh", self.runner.load_init_mesh))
        return self

    def __exit__(self, *exc):
        for obj, name, old in reversed(self._saved):
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def check_shapes(tag, shapes):
    """Prints the flash shapes a phase's path gave the kernel and fails
    unless phase 3 checked each of them."""
    log(f"[{tag}] flash_attention shapes over the requests (calls): "
        + ", ".join(f"{k} x{v}" for k, v in sorted(
            shapes.items(), key=lambda kv: str(kv[0]))))
    missing = [k for k in shapes if (k, 1.0) not in
               [(c[0], c[1]) for c in KERNEL_CASES]]
    if missing:
        raise AssertionError(f"{tag} shapes not checked in phase 3: "
                             f"{missing}")


def _record_shapes(TA, shapes):
    """A stand-in for `attention.flash_attention` that records each call's
    (B, L, H, D), or ((B, Lq, H, D), Lk) where the key length differs,
    and calls the kernel."""
    kernel = TA.flash_attention

    def recording(q, k, v):
        key = tuple(q.shape) if q.shape == k.shape else \
            (tuple(q.shape), k.shape[1])
        shapes[key] = shapes.get(key, 0) + 1
        return kernel(q, k, v)
    return kernel, recording


def phase_request(runner, tmp):
    """`run_3d_to_3d` at full width, twice (see the module doc). Returns the
    raster kernel's launches per part and the flash kernel's, summed over
    both requests, and what the tet-256 phase reuses."""
    import mvedit_tpu_torch.models.diffusion.attention as TA
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          launch)
    from mvedit_tpu_torch.models.mesh import Mesh
    from mvedit_tpu_torch.utils import profiling as PR
    knot = torus_knot()
    src = os.path.join(tmp, "knot.glb")
    Mesh(v=knot.v, f=knot.f).write_glb(src)
    log(f"[request] cuts in depth: steps {REQ_STEPS} (of 24), "
        f"init_inverse_steps {REQ_INIT_INV} (of 256), n_inverse_steps "
        f"{REQ_N_INV} (of 80), tet_init_inverse_steps {REQ_TET_INIT} (of "
        f"120); {REQ_VIEWS} views, 512^2, tet {TET}, LPIPS and SRVGG on")
    shapes = {}
    kernel, recording = _record_shapes(TA, shapes)
    out, total_parts, total_fa = None, {}, 0
    for run in ("cold", "warm"):
        dst = os.path.join(tmp, f"out_{run}.glb")
        pt = PR.PhaseTimer()
        PR.set_phase_timer(pt)
        TA.flash_attention = recording
        flash_attention.launches = 0
        staged, seg0 = launch.staged, SS.segment_sum.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with _PartCounter(runner) as parts:
                out = runner.run_3d_to_3d(
                    src, "a golden torus knot, studio light", seed=SEED,
                    steps=REQ_STEPS, num_views=REQ_VIEWS,
                    init_inverse_steps=REQ_INIT_INV,
                    n_inverse_steps=REQ_N_INV,
                    tet_init_inverse_steps=REQ_TET_INIT, out_path=dst)
                torch.cuda.synchronize()
        finally:
            TA.flash_attention = kernel
            PR.set_phase_timer(None)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        fa = flash_attention.launches
        mesh = out["mesh"]
        back = Mesh.load(dst)
        losses = torch.cat([x.float().flatten() for x in parts.losses])
        ok = (mesh is not None and back.albedo is not None
              and len(back.f) > 0 and mesh.albedo.shape == (1024, 1024, 3)
              and np.isfinite(mesh.albedo).all()
              and bool(torch.isfinite(losses).all()) and fa > 0
              and min(parts.parts.get(k, 0) for k in (
                  "load_init_mesh", "mesh_fit", "render_all", "bake")) > 0)
        log(f"[request] {run}: {wall:.3f} s wall, peak memory allocated "
            f"{peak / 2**30:.2f} GiB; GLB {len(back.f)} faces, albedo "
            f"{mesh.albedo.shape if mesh is not None else None}, "
            f"{losses.numel()} fit losses (first {float(losses[0]):.4f}, "
            f"last {float(losses[-1]):.4f}) {'ok' if ok else 'FAIL'}")
        for name, sec in pt.report().items():
            log(f"[request] {run}   phase {name}: {sec:.3f} s over "
                f"{pt.counts[name]} ticks: " + ", ".join(
                    f"{d:.3f} {sg}" for d, sg in zip(pt.durations[name],
                                                     pt.sigs[name])))
        log(f"[launches] {run} request: flash_attention {fa} (staged "
            f"copies {launch.staged - staged}); raster_select "
            + ", ".join(f"{v} in {k}" for k, v in parts.parts.items()))
        seg = SS.segment_sum.launches - seg0
        log(f"[launches] {run} request: segment_sum {seg}: "
            + ", ".join(f"{v} in {k}" for k, v in parts.seg_parts.items())
            + f", {seg - sum(parts.seg_parts.values())} outside these "
            f"parts")
        if not ok:
            raise AssertionError("the run_3d_to_3d request failed its checks")
        if run == "cold":
            # what phase 25's sharded request is held to
            with open(dst, "rb") as f:
                first = dict(rgb=out["renders"]["rgb"].clone(), glb=f.read(),
                             walls=[wall])
        else:
            first["walls"].append(wall)
        total_fa += fa
        for k, v in parts.parts.items():
            total_parts[k] = total_parts.get(k, 0) + v
    # one seed, one output: the cold and the warm request's GLBs
    glbs = [Mesh.load(os.path.join(tmp, f"out_{run}.glb"))
            for run in ("cold", "warm")]
    same = {k: bool(np.array_equal(getattr(glbs[0], k),
                                   getattr(glbs[1], k)))
            for k in ("v", "f", "albedo")}
    log(f"[request] cold and warm GLBs bit-equal (one seed): {same}")
    if not all(same.values()):
        raise AssertionError("two requests of one seed gave two GLBs")
    check_shapes("request", shapes)
    return total_parts, total_fa, dict(out=out, src=src, first=first)


def phase_tet256(runner, ctx):
    """Tet 256 on the request's fitted field: the switch, a cut first fit,
    then decimation (`mesh_reduction` 0.5), a cut texture refinement and
    the bake."""
    from mvedit_tpu_torch.models.mesh_fit import mesh_caps
    from mvedit_tpu_torch.native import native_available
    from mvedit_tpu_torch.pipelines.mvedit_3d import (GeneratorDraws,
                                                      MVEdit3DPipeline)
    if not native_available():
        raise AssertionError("the QEM decimation library did not build: "
                             "the tet-256 phase would skip it")
    m = runner.load_stable_diffusion()
    m.lpips_params = runner.load_lpips()
    cfg = runner._mvedit_cfg(REQ_VIEWS, REQ_STEPS, REQ_N_INV, REQ_INIT_INV,
                             tet_resolution=TET_BIG,
                             mesh_simplify_texture_steps=REFINE_STEPS)
    # 128 / 256, as `_mvedit_cfg` sets it at tet 256
    pipe = MVEdit3DPipeline(m, dataclasses.replace(cfg, mesh_reduction=0.5))
    poses, intr, lights = _rig(SIZE)
    init = runner.load_init_mesh(torus_knot(), poses, intr, SIZE, lights)
    t = {k: torch.as_tensor(v, device=DEV) for k, v in
         (("poses", poses), ("intrinsics", intr), ("cam_lights", lights))}
    targets = {"images": init["images"], "masks": init["masks"],
               "cam_weights": torch.ones(REQ_VIEWS, device=DEV), **t}
    field = {"table": {k: v.detach().clone() for k, v in
                       ctx["out"]["nerf_params"]["table"].items()},
             "mlp": [{k: v.detach().clone() for k, v in l.items()}
                     for l in ctx["out"]["nerf_params"]["mlp"]]}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tet_grid, state, opt = pipe._init_mesh_phase(field, device=DEV)
    torch.cuda.synchronize()
    t_switch = time.perf_counter() - t0
    run, _, _ = pipe._mesh_fit_fns(tet_grid, TET_BIG_FIT)
    t0 = time.perf_counter()
    state, opt, out = run(state, opt, targets,
                          sched=pipe._sched_weights(0.65, "mesh"),
                          generator=gen, lpips_params=m.lpips_params)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    mt = out["mt"]
    # n_faces counts every crossing; past the cap (as the reference's
    # static buffers) faces are dropped and `face_mask` keeps the rest
    nf, kept = int(mt["n_faces"]), int(mt["face_mask"].sum())
    fcap = mesh_caps(TET_BIG)[1]
    t0 = time.perf_counter()
    mesh = pipe._extract_and_bake(state, mt, targets, GeneratorDraws(gen),
                                  m.lpips_params)
    torch.cuda.synchronize()
    t_bake = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ok = (bool(torch.isfinite(out["loss"]).all()) and 0 < kept <= fcap
          and mesh is not None and len(mesh.f) <= 0.55 * kept
          and np.isfinite(mesh.albedo).all())
    log(f"[tet256] switch {t_switch:.3f} s ({TET_BIG + 1}^3 = "
        f"{(TET_BIG + 1) ** 3} verts); {TET_BIG_FIT} fit steps {t_fit:.3f} "
        f"s, loss {float(out['loss'][0]):.4f} -> "
        f"{float(out['loss'][-1]):.4f}; {nf} faces extracted, {kept} kept "
        f"(cap {fcap}); decimation to "
        f"{len(mesh.f) if mesh is not None else None} faces + "
        f"{REFINE_STEPS} refine steps + bake {t_bake:.3f} s; peak "
        f"{peak / 2**30:.2f} GiB {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the tet-256 phase failed its checks")


_ST_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16",
             torch.float16: "F16", torch.int64: "I64", torch.bool: "BOOL"}


def write_safetensors(path, state):
    """A `.safetensors` file written by hand (the card's machine has no
    `safetensors` package): an 8-byte little-endian header length, the
    JSON header (dtype, shape, byte range of each tensor), the raw
    little-endian bytes."""
    header, blobs, off = {}, [], 0
    for k, v in state.items():
        v = v.detach().contiguous().cpu()
        raw = v.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": _ST_NAMES[v.dtype], "shape": list(v.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little"))
        f.write(h)
        for b in blobs:
            f.write(b)


def phase_checkpoint(tmp):
    """A round trip through `checkpoint_dir`: a runner's seeded SRVGG
    enhancer and full-size tile ControlNet (its zero-initialised heads
    given seeded values, so that its residuals are not all zero) written
    as `.safetensors` and as `.bin` (SRVGG under Real-ESRGAN's
    "params_ema"), each loaded by a runner of another seed: the outputs
    must be equal on the card."""
    from mvedit_tpu_torch.apis import Adapter3DRunner
    src = Adapter3DRunner(seed=SEED + 200, device=DEV)
    enhance = src.load_image_enhancer()
    cn = src.load_controlnets(("tile",))[0]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    with torch.no_grad():
        for name, p in cn.named_parameters():
            if "controlnet_" in name and not name.startswith(
                    "controlnet_cond_embedding.blocks"):
                p.copy_(torch.randn(p.shape, generator=gen, device=DEV,
                                    dtype=p.dtype) * 0.02)
    img = torch.rand((2, 128, 128, 3), generator=gen, device=DEV)
    lat = torch.randn((2, SIZE // 8, SIZE // 8, 4), generator=gen,
                      device=DEV)
    t = torch.full((2,), 500, dtype=torch.int32, device=DEV)
    ctx = torch.randn((2, 77, cn.cfg.cross_attention_dim), generator=gen,
                      device=DEV)
    # the hint at the image size: 8x the latent (2x with tiny models)
    hs = SIZE // 8 * (2 if src.tiny else 8)
    hint = torch.rand((2, hs, hs, 3), generator=gen, device=DEV)

    def outputs(enh, net):
        with torch.inference_mode():
            downs, mid = net(lat, t, ctx, hint)
            return [enh(img, SIZE)] + list(downs) + [mid]
    ref = outputs(enhance, cn)
    states = {"image_enhancer": src._cache["srvgg"].state_dict(),
              "controlnet_tile": cn.state_dict()}
    for fmt in ("safetensors", "bin"):
        root = os.path.join(tmp, f"checkpoint_{fmt}")
        t0 = time.perf_counter()
        for sub, st in states.items():
            if fmt == "safetensors":
                write_safetensors(os.path.join(root, sub,
                                               f"{sub}.safetensors"), st)
            else:
                os.makedirs(os.path.join(root, sub), exist_ok=True)
                torch.save({"params_ema": st} if sub == "image_enhancer"
                           else st, os.path.join(root, sub,
                                                 "pytorch_model.bin"))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        dst = Adapter3DRunner(checkpoint_dir=root, seed=SEED + 300,
                              device=DEV)
        out = outputs(dst.load_image_enhancer(),
                      dst.load_controlnets(("tile",))[0])
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        equal = all(bool(torch.equal(a, b)) for a, b in zip(out, ref))
        nonzero = all(float(x.abs().max()) > 0 for x in ref)
        log(f"[checkpoint] {fmt}: SRVGG + tile ControlNet ("
            f"{sum(p.numel() for p in cn.parameters()) / 1e6:.1f}M "
            f"parameters) written in {t_write:.2f} s, loaded by a runner "
            f"of another seed and run in {t_load:.2f} s; outputs equal "
            f"{equal} {'ok' if equal and nonzero else 'FAIL'}")
        if not (equal and nonzero):
            raise AssertionError(f"the {fmt} checkpoint round trip changed "
                                 f"the outputs")
        del dst, out
    del src, enhance, cn, states
    torch.cuda.empty_cache()
    # what phase 26's convert_weights round trip is held to
    return dict(ref=ref, outputs=outputs)


def phase_retex(runner, tmp):
    """`run_retex` at full width, twice with one seed (see the module
    doc). Returns the flash, raster and segment-sum launches of the two
    requests."""
    import mvedit_tpu_torch.models.diffusion.attention as TA
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          launch)
    from mvedit_tpu_torch.models.mesh import Mesh
    knot = torus_knot()
    src = os.path.join(tmp, "retex_knot.glb")
    Mesh(v=knot.v, f=knot.f).write_glb(src)
    img = np.random.default_rng(SEED + 13).random(
        (SIZE, SIZE, 3)).astype(np.float32)
    log(f"[retex] {RETEX_VIEWS} views + the top view (front_view_id 0), "
        f"{SIZE}^2, steps {RETEX_STEPS} at strength 0.7, n_inverse_steps "
        f"{RETEX_N_INV} (the defaults; no cut in depth), tile + depth "
        f"ControlNets, 2-pass, LPIPS on, dense field (32, 160), a seeded "
        f"{SIZE}^2 in_image through IP-Adapter")
    shapes = {}
    kernel, recording = _record_shapes(TA, shapes)
    albedos, totals = [], dict(flash=0, raster=0, segment=0)
    for run in ("first", "second"):
        dst = os.path.join(tmp, f"retex_{run}.glb")
        TA.flash_attention = recording
        flash_attention.launches = RS.raster_select.launches = 0
        SS.segment_sum.launches = 0
        staged = (launch.staged, RS.raster_select.staged,
                  SS.segment_sum.staged)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = runner.run_retex(
                src, "a golden torus knot, studio light", seed=SEED,
                steps=RETEX_STEPS, n_inverse_steps=RETEX_N_INV,
                num_views=RETEX_VIEWS, front_view_id=0, in_image=img,
                out_path=dst)
            torch.cuda.synchronize()
        finally:
            TA.flash_attention = kernel
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n = dict(flash=flash_attention.launches,
                 raster=RS.raster_select.launches,
                 segment=SS.segment_sum.launches)
        for k in totals:
            totals[k] += n[k]
        albedo = out["mesh"].albedo
        losses = torch.cat([x.float().flatten() for x in out["fit_losses"]])
        back = Mesh.load(dst)
        ok = (albedo.shape == (1024, 1024, 3) and np.isfinite(albedo).all()
              and bool(torch.isfinite(losses).all())
              and back.albedo is not None and min(n.values()) > 0
              and out["renders"].shape[1:] == (SIZE, SIZE, 3)
              and (launch.staged, RS.raster_select.staged,
                   SS.segment_sum.staged) == staged)
        log(f"[retex] {run}: {wall:.3f} s wall, peak memory allocated "
            f"{peak / 2**30:.2f} GiB; {len(out['fit_losses'])} timesteps, "
            f"{out['renders'].shape[0]} views at the end, "
            f"{losses.numel()} fit losses (first {float(losses[0]):.4f}, "
            f"last {float(losses[-1]):.4f}); albedo mean "
            f"{float(albedo.mean()):.4f} {'ok' if ok else 'FAIL'}")
        log(f"[launches] retex {run}: flash_attention {n['flash']}, "
            f"raster_select {n['raster']}, segment_sum {n['segment']}")
        if not ok:
            raise AssertionError("the run_retex request failed its checks")
        albedos.append(albedo)
        del out
    same = bool(np.array_equal(albedos[0], albedos[1]))
    log(f"[retex] the two albedos of one seed bit-equal: {same}")
    if not same:
        raise AssertionError("two retex requests of one seed differ")
    check_shapes("retex", shapes)
    return totals


def phase_superres(runner, tmp):
    """Texture superres at full width (see the module doc): two standalone
    `run_texture_superres` requests of one seed on phase 10's GLB, one
    `run_retex(..., superres=True)` at phase 10's settings, and one
    `run_mesh_to_video` of the superres GLB. Returns the flash, raster
    (tile 32 apart) and segment-sum launches of the requests and the
    video."""
    import importlib
    import mvedit_tpu_torch.models.diffusion.attention as TA
    import mvedit_tpu_torch.utils.video as V
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          launch)
    from mvedit_tpu_torch.models.mesh import Mesh, RasterConfig
    from mvedit_tpu_torch.utils import profiling as PR
    RZ = importlib.import_module("mvedit_tpu_torch.models.mesh.rasterize")
    src = os.path.join(tmp, "retex_first.glb")
    prompt = "a golden torus knot, studio light"
    # the bake's tile load on the input's atlas (the request's own
    # normalisation moves no uv): faces past K are dropped, as in the
    # reference
    mesh = runner.run_mesh_preproc(src)["mesh"]
    acfg = RasterConfig(height=SR_ATLAS, width=SR_ATLAS, tile=32,
                        k_per_tile=64, k_big=32)
    uv = torch.as_tensor(mesh.vt, device=DEV)
    pairs, big = RZ.tile_load(
        torch.stack([uv[:, 0] * SR_ATLAS, uv[:, 1] * SR_ATLAS,
                     torch.ones_like(uv[:, 0])], -1),
        torch.as_tensor(mesh.ft, device=DEV),
        torch.ones(len(mesh.ft), dtype=torch.bool, device=DEV), acfg)
    over = pairs > acfg.k_per_tile
    dropped = int((pairs - acfg.k_per_tile).clamp(min=0).sum())
    log(f"[superres] input: phase 10's GLB, {len(mesh.f)} faces, "
        f"{len(mesh.v)} vertices with uvs, albedo "
        f"{None if mesh.albedo is None else mesh.albedo.shape}; the "
        f"{SR_ATLAS}^2 bake at tile 32, K 64 + 32: {int(over.sum())} of "
        f"{acfg.num_tiles} tiles overflow ({dropped} pairs dropped; the "
        f"most in a tile {int(pairs.max())}), {big} big triangles (K "
        f"{acfg.k_big})")
    log(f"[superres] the endpoint's defaults (no cut in depth): 8 views "
        f"(6 + 2 polar) of {SIZE}^2, 24 steps at strength 0.4 (10 "
        f"timesteps), 2-pass at 2N = 16, IP-Adapter on the input's "
        f"albedo, 512 fit steps with LPIPS, dense field (32, 160), "
        f"{SR_ATLAS}^2 bake")
    shapes = {}
    kernel, recording = _record_shapes(TA, shapes)
    totals = dict(flash=0, raster=0, tile32=0, segment=0)
    staged = (launch.staged, RS.raster_select.staged, SS.segment_sum.staged)

    def run(tag, fn):
        pt = PR.PhaseTimer()
        PR.set_phase_timer(pt)
        TA.flash_attention = recording
        flash_attention.launches = RS.raster_select.launches = 0
        RS.raster_select.tile32_launches = SS.segment_sum.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            TA.flash_attention = kernel
            PR.set_phase_timer(None)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n = dict(flash=flash_attention.launches,
                 raster=RS.raster_select.launches,
                 tile32=RS.raster_select.tile32_launches,
                 segment=SS.segment_sum.launches)
        for k in totals:
            totals[k] += n[k]
        log(f"[superres] {tag}: {wall:.3f} s wall, peak memory allocated "
            f"{peak / 2**30:.2f} GiB")
        for name, sec in pt.report().items():
            log(f"[superres] {tag}   phase {name}: {sec:.3f} s over "
                f"{pt.counts[name]} ticks")
        log(f"[launches] superres {tag}: flash_attention {n['flash']}, "
            f"raster_select {n['raster']} ({n['raster'] - n['tile32']} at "
            f"tile 16, {n['tile32']} at tile 32), segment_sum "
            f"{n['segment']}")
        return out, n

    def check(tag, out, n, losses):
        albedo = out["mesh"].albedo
        ok = (albedo.shape == (SR_ATLAS, SR_ATLAS, 3)
              and np.isfinite(albedo).all()
              and losses.shape == (SR_FIT_STEPS,)
              and bool(torch.isfinite(losses).all())
              and n["flash"] > 0 and n["segment"] > 0 and n["tile32"] >= 1
              and n["raster"] > n["tile32"]
              and (launch.staged, RS.raster_select.staged,
                   SS.segment_sum.staged) == staged)
        log(f"[superres] {tag}: albedo {albedo.shape} mean "
            f"{float(albedo.mean()):.4f}, {losses.numel()} fit losses "
            f"(first {float(losses[0]):.4f}, last {float(losses[-1]):.4f}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the superres {tag} request failed its "
                                 f"checks")

    albedos = []
    for tag in ("first", "second"):
        dst = os.path.join(tmp, f"superres_{tag}.glb")
        out, n = run(tag, lambda: runner.run_texture_superres(
            src, prompt, seed=SEED, out_path=dst))
        check(tag, out, n, out["fit_losses"].float())
        if out["renders"].shape != (8, SIZE, SIZE, 3):
            raise AssertionError("superres renders of another shape")
        albedos.append(out["mesh"].albedo)
        del out
    same = bool(np.array_equal(albedos[0], albedos[1]))
    log(f"[superres] the two {SR_ATLAS}^2 albedos of one seed bit-equal: "
        f"{same}")
    if not same:
        raise AssertionError("two superres requests of one seed differ")
    del albedos
    # retex with its live field handed to superres, at phase 10's settings
    img = np.random.default_rng(SEED + 13).random(
        (SIZE, SIZE, 3)).astype(np.float32)
    knot = os.path.join(tmp, "retex_knot.glb")
    out, n = run("chained retex + superres", lambda: runner.run_retex(
        knot, prompt, seed=SEED, steps=RETEX_STEPS,
        n_inverse_steps=RETEX_N_INV, num_views=RETEX_VIEWS,
        front_view_id=0, in_image=img, superres=True))
    check("chained retex + superres", out, n,
          out["superres_fit_losses"].float())
    del out
    # an orbit video of the superres GLB, its frames captured
    frames = {}
    write = V.write_video

    def capture(fr, path, fps=30):
        frames["f"] = np.asarray(fr)
        return write(fr, path, fps)
    V.write_video = capture
    try:
        path, n = run("video", lambda: runner.run_mesh_to_video(
            os.path.join(tmp, "superres_first.glb"),
            out_path=os.path.join(tmp, "superres.mp4"),
            num_frames=VIDEO_FRAMES))
    finally:
        V.write_video = write
    fr = frames["f"]
    ok = (os.path.exists(path) and os.path.getsize(path) > 0
          and fr.shape == (VIDEO_FRAMES, SIZE, SIZE, 3)
          and np.isfinite(fr).all() and n["raster"] == VIDEO_FRAMES
          and float(fr.std()) > 0.01)
    log(f"[superres] video: {fr.shape[0]} frames of {fr.shape[1:3]}, "
        f"written to {os.path.basename(path)} ({os.path.getsize(path)} "
        f"bytes), frame mean {float(fr.mean()):.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("run_mesh_to_video failed its checks")
    check_shapes("superres", shapes)
    return totals

# kernel families by name, first match wins
def i23_input(runner):
    """The image-to-3D input: the seeded torus knot rendered by the port
    at the front pose (azimuth 0, elevation 0.3, the v1.1 rig's distance)
    to I23_INPUT^2, Lambert-shaded, composited on white."""
    from mvedit_tpu_torch.apis import cameras as C
    from mvedit_tpu_torch.utils import camera as cam_utils
    # 38k faces: few enough per raster tile that none overflows at 512^2
    knot = torus_knot(nu=400, nv=48)
    _, fov, dist = C.zero123plus_v11_rig()
    pose = cam_utils.get_pose_from_angles(np.array([0.0]), np.array([0.3]),
                                          dist)[:, :3]
    intr = cam_utils.intrinsics_from_fov(fov, I23_INPUT, I23_INPUT)[None]
    light = pose[:, :3, 3] / np.linalg.norm(pose[:, :3, 3], axis=-1,
                                            keepdims=True)
    init = runner.load_init_mesh(knot, pose, intr, I23_INPUT, light)
    return init["images"][0].float().cpu().numpy()


class _Timed:
    """Wall time (after a device sync) and calls of named runner methods,
    and of the MVEdit loop's per-step segmentation hook."""

    def __init__(self, runner, names):
        self.runner, self.names = runner, names
        self.sec = {}

    def _wrap(self, name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.sec.setdefault(name, []).append(time.perf_counter() - t0)
        return wrapped

    def __enter__(self):
        for name in self.names:
            setattr(self.runner, name,
                    self._wrap(name, getattr(self.runner, name)))
        make = self.runner.make_segment_fn
        self.runner.make_segment_fn = lambda: self._wrap(
            "segment_fn (each step)", make())
        return self

    def __exit__(self, *exc):
        for name in self.names + ["make_segment_fn"]:
            del self.runner.__dict__[name]


def phase_image_to_3d(runner, tmp):
    """`run_zero123plus_to_mesh` (v1.1) at full width, twice with one seed
    (see the module doc). Returns the flash, raster and segment-sum
    launches of the two requests and the flash launches by shape."""
    import mvedit_tpu_torch.models.diffusion.attention as TA
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          launch)
    from mvedit_tpu_torch.models.mesh import Mesh
    from mvedit_tpu_torch.utils import profiling as PR
    img = i23_input(runner)
    log(f"[image_to_3d] input: the knot at the front pose, {I23_INPUT}^2 on "
        f"white (foreground {float((img < 0.999).any(-1).mean()):.3f} of "
        f"the pixels); Zero123++ v1.1 at 40 steps, 960 x 640 grid, "
        f"{I23_PASSES} of 6 passes (one mirrored): 1 + {6 * I23_PASSES} "
        f"views; TRACER-B7 at 640^2, DPT-hybrid at 384^2, LoFTR (4 layers) "
        f"at 256^2, IP-Adapter, LPIPS and SRVGG on; cuts in depth: steps "
        f"{REQ_STEPS} (of 24), init_inverse_steps {REQ_INIT_INV} (of 640), "
        f"n_inverse_steps {REQ_N_INV} (of 80), tet_init_inverse_steps "
        f"{REQ_TET_INIT} (of 120); superres off")
    shapes = {}
    kernel, recording = _record_shapes(TA, shapes)
    grids, glbs = [], []
    totals = dict(flash=0, raster=0, segment=0)
    for run in ("first", "second"):
        dst = os.path.join(tmp, f"i23_{run}.glb")
        pt = PR.PhaseTimer()
        PR.set_phase_timer(pt)
        TA.flash_attention = recording
        flash_attention.launches = RS.raster_select.launches = 0
        SS.segment_sum.launches = 0
        staged = (launch.staged, RS.raster_select.staged,
                  SS.segment_sum.staged)
        run_shapes = dict(shapes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with _Timed(runner, ["run_zero123plus", "run_segmentation",
                                 "predict_normals", "estimate_input_pose",
                                 "enable_ip_adapter"]) as tm:
                out = runner.run_zero123plus_to_mesh(
                    img, seed=SEED, passes=I23_PASSES, steps=REQ_STEPS,
                    init_inverse_steps=REQ_INIT_INV,
                    n_inverse_steps=REQ_N_INV,
                    tet_init_inverse_steps=REQ_TET_INIT, out_path=dst)
                torch.cuda.synchronize()
        finally:
            TA.flash_attention = kernel
            PR.set_phase_timer(None)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n = dict(flash=flash_attention.launches,
                 raster=RS.raster_select.launches,
                 segment=SS.segment_sum.launches)
        for k in totals:
            totals[k] += n[k]
        z_shapes = {k: shapes.get(k, 0) - run_shapes.get(k, 0)
                    for k in Z123_CASES}
        mesh, views = out["mesh"], out["views"]
        back = Mesh.load(dst)
        ok = (mesh is not None and back.albedo is not None
              and len(back.f) > 0 and np.isfinite(mesh.albedo).all()
              and views.shape == (6 * I23_PASSES, I23_VIEW, I23_VIEW, 3)
              and np.isfinite(views).all() and min(n.values()) > 0
              and min(z_shapes.values()) > 0
              and (launch.staged, RS.raster_select.staged,
                   SS.segment_sum.staged) == staged)
        log(f"[image_to_3d] {run}: {wall:.3f} s wall, peak memory "
            f"allocated {peak / 2**30:.2f} GiB; views {views.shape} (mean "
            f"{float(views.mean()):.4f}), GLB {len(back.f)} faces, albedo "
            f"{mesh.albedo.shape if mesh is not None else None}; pose route "
            f"{out['pose_route']} ({runner.last_match_count} LoFTR matches "
            f"over the first 6 views; input pose centre "
            f"{np.round(out['in_pose'][:3, 3], 4).tolist()}) "
            f"{'ok' if ok else 'FAIL'}")
        for name, secs in tm.sec.items():
            log(f"[image_to_3d] {run}   {name}: {sum(secs):.3f} s over "
                f"{len(secs)} calls (" + ", ".join(f"{x:.3f}" for x in secs)
                + ")")
        for name, sec in pt.report().items():
            log(f"[image_to_3d] {run}   phase {name}: {sec:.3f} s over "
                f"{pt.counts[name]} ticks")
        log(f"[launches] image_to_3d {run}: flash_attention {n['flash']} "
            f"(at {Z123_CASES[0]}: {z_shapes[Z123_CASES[0]]}, at "
            f"{Z123_CASES[1]}: {z_shapes[Z123_CASES[1]]}; staged copies "
            f"{launch.staged - staged[0]}), raster_select {n['raster']}, "
            f"segment_sum {n['segment']}")
        if not ok:
            raise AssertionError("the run_zero123plus_to_mesh request "
                                 "failed its checks")
        grids.append(views)
        glbs.append(back)
        del out
    same = dict(views=bool(np.array_equal(grids[0], grids[1])),
                **{k: bool(np.array_equal(getattr(glbs[0], k),
                                          getattr(glbs[1], k)))
                   for k in ("v", "f", "albedo")})
    log(f"[image_to_3d] the two requests of one seed bit-equal: {same}")
    if not all(same.values()):
        raise AssertionError("two image-to-3D requests of one seed differ")
    check_shapes("image_to_3d", shapes)
    totals["by_shape"] = {str(k): shapes.get(k, 0) for k in Z123_CASES}
    return totals


class _TimedCalls:
    """Wall time (after a device sync) of every call of named module or
    class attributes, under names of the caller's choice; `name_of(args,
    kwargs)` may pick the name per call."""

    def __init__(self, targets):
        self.targets = targets          # [(owner, attr, name_of)]
        self.sec, self._saved = {}, []

    def __enter__(self):
        for owner, attr, name_of in self.targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))

            def wrapped(*a, _fn=fn, _name=name_of, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    self.sec.setdefault(_name(a, k), []).append(
                        time.perf_counter() - t0)
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)


def phase_image_to_3d_v12(runner, tmp):
    """`run_zero123plus1_2_to_mesh` at full width with its generated
    normals, twice with one seed (see the module doc). Returns the flash,
    raster and segment-sum launches of the two requests and the flash
    launches at Zero123++'s shapes."""
    import mvedit_tpu_torch.models.diffusion.attention as TA
    import mvedit_tpu_torch.pipelines.preproc as PP
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          launch)
    from mvedit_tpu_torch.models.mesh import Mesh
    from mvedit_tpu_torch.pipelines.zero123plus import Zero123PlusPipeline
    from mvedit_tpu_torch.utils import profiling as PR
    img = i23_input(runner)
    log(f"[image_to_3d_v12] input: phase 12's; Zero123++ v1.2 at 40 steps "
        f"on the 960 x 640 grid, then its normal pass (a second SD1.5 UNet "
        f"and the normal ControlNet on the RGB grid, 40 steps), "
        f"{I23_PASSES} of 6 passes: 1 + {6 * I23_PASSES} views, each "
        f"generated view matted by its normals and supervised by them; "
        f"phase 12's cuts in depth")
    shapes = {}
    kernel, recording = _record_shapes(TA, shapes)
    outs, glbs = [], []
    totals = dict(flash=0, raster=0, segment=0)
    for run in ("first", "second"):
        dst = os.path.join(tmp, f"i23v12_{run}.glb")
        pt = PR.PhaseTimer()
        PR.set_phase_timer(pt)
        TA.flash_attention = recording
        flash_attention.launches = RS.raster_select.launches = 0
        SS.segment_sum.launches = 0
        staged = (launch.staged, RS.raster_select.staged,
                  SS.segment_sum.staged)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with _Timed(runner, ["run_segmentation", "predict_normals",
                                 "estimate_input_pose",
                                 "enable_ip_adapter"]) as tm, \
                    _TimedCalls([
                        (Zero123PlusPipeline, "__call__",
                         lambda a, k: "Zero123++ normal pass"
                         if k.get("normal_cond") is not None
                         else "Zero123++ RGB pass"),
                        (PP, "zero123plus_postprocess",
                         lambda a, k: "postprocess (each view)")]) as tc:
                out = runner.run_zero123plus1_2_to_mesh(
                    img, seed=SEED, passes=I23_PASSES, steps=REQ_STEPS,
                    init_inverse_steps=REQ_INIT_INV,
                    n_inverse_steps=REQ_N_INV,
                    tet_init_inverse_steps=REQ_TET_INIT, out_path=dst)
                torch.cuda.synchronize()
        finally:
            TA.flash_attention = kernel
            PR.set_phase_timer(None)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n = dict(flash=flash_attention.launches,
                 raster=RS.raster_select.launches,
                 segment=SS.segment_sum.launches)
        for k in totals:
            totals[k] += n[k]
        mesh, views, normals = out["mesh"], out["views"], out["normals"]
        back = Mesh.load(dst)
        shape = (6 * I23_PASSES, I23_VIEW, I23_VIEW, 3)
        ok = (mesh is not None and back.albedo is not None
              and len(back.f) > 0 and np.isfinite(mesh.albedo).all()
              and views.shape == normals.shape == shape
              and np.isfinite(views).all() and np.isfinite(normals).all()
              and min(n.values()) > 0
              and len(tc.sec.get("Zero123++ normal pass", [])) == I23_PASSES
              and (launch.staged, RS.raster_select.staged,
                   SS.segment_sum.staged) == staged)
        log(f"[image_to_3d_v12] {run}: {wall:.3f} s wall, peak memory "
            f"allocated {peak / 2**30:.2f} GiB; views {views.shape} (mean "
            f"{float(views.mean()):.4f}), normals (mean "
            f"{float(normals.mean()):.4f}), GLB {len(back.f)} faces; pose "
            f"route {out['pose_route']} {'ok' if ok else 'FAIL'}")
        for name, secs in list(tc.sec.items()) + list(tm.sec.items()):
            log(f"[image_to_3d_v12] {run}   {name}: {sum(secs):.3f} s over "
                f"{len(secs)} calls")
        for name, sec in pt.report().items():
            log(f"[image_to_3d_v12] {run}   phase {name}: {sec:.3f} s over "
                f"{pt.counts[name]} ticks")
        log(f"[launches] image_to_3d_v12 {run}: flash_attention "
            f"{n['flash']}, raster_select {n['raster']}, segment_sum "
            f"{n['segment']}")
        if not ok:
            raise AssertionError("the run_zero123plus1_2_to_mesh request "
                                 "failed its checks")
        outs.append((views, normals))
        glbs.append(back)
        del out
    same = dict(views=bool(np.array_equal(outs[0][0], outs[1][0])),
                normals=bool(np.array_equal(outs[0][1], outs[1][1])),
                **{k: bool(np.array_equal(getattr(glbs[0], k),
                                          getattr(glbs[1], k)))
                   for k in ("v", "f", "albedo")})
    log(f"[image_to_3d_v12] the two requests of one seed bit-equal: {same}")
    if not all(same.values()):
        raise AssertionError("two v1.2 image-to-3D requests of one seed "
                             "differ")
    check_shapes("image_to_3d_v12", shapes)
    totals["by_shape"] = {str(k): shapes.get(k, 0) for k in Z123_CASES}
    return totals


def phase_sam(runner):
    """`run_segmentation` with SAM ViT-H (f32), bg_color and erosion on
    phase 12's input view and SAM_VIEWS of the knot's renders, twice."""
    img = i23_input(runner)
    poses, intr, lights = _rig(SIZE)
    knot = runner.load_init_mesh(torus_knot(nu=400, nv=48),
                                 poses[:SAM_VIEWS], intr[:SAM_VIEWS], SIZE,
                                 lights[:SAM_VIEWS])["images"]
    views = np.concatenate([img[None], knot.float().cpu().numpy()], 0)
    calls = []
    make = runner.make_sam_refine_fn

    def counted():
        refine = make()

        def f(*a):
            calls.append(a[1])
            return refine(*a)
        return f
    runner.make_sam_refine_fn = counted
    masks = []
    try:
        for run in ("first", "second"):
            calls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = runner.run_segmentation(views, use_sam=True,
                                        bg_color=(1.0, 1.0, 1.0),
                                        erosion=2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            fg = m.reshape(len(views), -1).mean(1).tolist()
            ok = (tuple(m.shape) == views.shape[:3] + (1,)
                  and bool(torch.isfinite(m).all())
                  and len(calls) == len(views))
            log(f"[sam] {run}: {len(views)} views of {views.shape[1]}^2, "
                f"{len(calls)} SAM calls, {wall:.3f} s wall "
                f"({wall / len(views):.3f} s an image), peak memory "
                f"allocated {peak / 2**30:.2f} GiB; foreground "
                f"{[round(x, 4) for x in fg]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("SAM refinement failed its checks")
            masks.append(m)
    finally:
        del runner.make_sam_refine_fn
    same = bool(torch.equal(masks[0], masks[1]))
    log(f"[sam] the two runs bit-equal: {same}")
    if not same:
        raise AssertionError("two SAM refinements of one input differ")


def phase_zero123(runner):
    """Legacy Zero123 at SD1.5 widths: a seeded 8-channel UNet, CLIP
    ViT-L/14 with a 768 projection and `CLIPCameraProjection`, the SD VAE,
    256^2, Z123_LEGACY_STEPS DDIM steps, twice with one seed."""
    import dataclasses as dc
    import types
    from mvedit_tpu_torch.models.diffusion import (SD15_UNET,
                                                   UNet2DCondition)
    from mvedit_tpu_torch.models.diffusion import schedulers as S
    from mvedit_tpu_torch.models.diffusion.clip import (CLIPVisionConfig,
                                                        CLIPVisionModel)
    from mvedit_tpu_torch.ops.image import resize_bilinear
    from mvedit_tpu_torch.pipelines.zero123 import (CLIPCameraProjection,
                                                    Zero123Config,
                                                    Zero123Pipeline)
    m = types.SimpleNamespace(schedule=S.sd_schedule(),
                              vae=runner.load_stable_diffusion().vae)
    m.unet = runner._build("zero123_unet", lambda: UNet2DCondition(
        dc.replace(SD15_UNET, in_channels=8)), seed_offset=11)
    vcfg = CLIPVisionConfig(projection_dim=768)
    m.vision = runner._build("zero123_vision",
                             lambda: CLIPVisionModel(vcfg), seed_offset=12)
    m.ccp = runner._build("zero123_ccp", CLIPCameraProjection,
                          seed_offset=13, cast=False)
    img = torch.as_tensor(i23_input(runner), device=DEV)[None]
    mean = torch.tensor([0.4815, 0.4578, 0.4082], device=DEV)
    std = torch.tensor([0.2686, 0.2613, 0.2758], device=DEV)
    clip_px = (resize_bilinear(img, (vcfg.image_size,) * 2) - mean) / std
    pipe = Zero123Pipeline(m, Zero123Config(num_steps=Z123_LEGACY_STEPS))
    outs = []
    for run in ("first", "second"):
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pipe(resize_bilinear(img, (256, 256)), clip_px, 30.0, 45.0,
                   1.5, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = (tuple(out.shape) == (1, 256, 256, 3)
              and bool(torch.isfinite(out).all()))
        log(f"[zero123] {run}: {Z123_LEGACY_STEPS} DDIM steps at 256^2, "
            f"{wall:.3f} s wall, peak memory allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; image "
            f"mean {float(out.mean()):.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("legacy Zero123 failed its checks")
        outs.append(out)
    same = bool(torch.equal(outs[0], outs[1]))
    log(f"[zero123] the two runs bit-equal: {same}")
    if not same:
        raise AssertionError("two Zero123 runs of one seed differ")


def phase_tet_unstructured(runner, ctx):
    """The unstructured tet grid at TET on the request's fitted field:
    `build_grid_tets` cold and cached, the switch with
    `structured_tets=False`, UNSTRUCT_FIT_STEPS fit steps and the
    extraction. Returns the raster and segment-sum launches."""
    import tempfile
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.models.mesh import build_grid_tets
    from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline
    m = runner.load_stable_diffusion()
    m.lpips_params = runner.load_lpips()
    cfg = runner._mvedit_cfg(REQ_VIEWS, REQ_STEPS, REQ_N_INV, REQ_INIT_INV,
                             tet_resolution=TET, structured_tets=False)
    pipe = MVEdit3DPipeline(m, cfg)
    poses, intr, lights = _rig(SIZE)
    init = runner.load_init_mesh(torus_knot(), poses, intr, SIZE, lights)
    t = {k: torch.as_tensor(v, device=DEV) for k, v in
         (("poses", poses), ("intrinsics", intr), ("cam_lights", lights))}
    targets = {"images": init["images"], "masks": init["masks"],
               "cam_weights": torch.ones(REQ_VIEWS, device=DEV), **t}
    field = {"table": {k: v.detach().clone() for k, v in
                       ctx["out"]["nerf_params"]["table"].items()},
             "mlp": [{k: v.detach().clone() for k, v in l.items()}
                     for l in ctx["out"]["nerf_params"]["mlp"]]}
    saved = os.environ.get("MVEDIT_TORCH_TET_CACHE")
    with tempfile.TemporaryDirectory() as cache:
        os.environ["MVEDIT_TORCH_TET_CACHE"] = cache
        try:
            t0 = time.perf_counter()
            grid = build_grid_tets(TET)
            t_cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            build_grid_tets(TET)
            t_cached = time.perf_counter() - t0
            RS.raster_select.launches = SS.segment_sum.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tet_grid, state, opt = pipe._init_mesh_phase(field, device=DEV)
            torch.cuda.synchronize()
            t_switch = time.perf_counter() - t0
        finally:
            if saved is None:
                del os.environ["MVEDIT_TORCH_TET_CACHE"]
            else:
                os.environ["MVEDIT_TORCH_TET_CACHE"] = saved
    run, _, _ = pipe._mesh_fit_fns(tet_grid, UNSTRUCT_FIT_STEPS)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    t0 = time.perf_counter()
    state, opt, out = run(state, opt, targets,
                          sched=pipe._sched_weights(0.65, "mesh"),
                          generator=gen, lpips_params=m.lpips_params)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    mt = out["mt"]
    # below tet 32 the fit keeps the full buffers, with no counts
    vcap, fcap = len(mt["vert_mask"]), run.face_cap
    nv = int(mt["n_verts"] if "n_verts" in mt else mt["vert_mask"].sum())
    nf = int(mt["n_faces"] if "n_faces" in mt else mt["face_mask"].sum())
    kept = int(mt["face_mask"].sum())
    n = dict(raster=RS.raster_select.launches,
             segment=SS.segment_sum.launches)
    ok = (bool(torch.isfinite(out["loss"]).all()) and kept > 0
          and min(n.values()) > 0 and len(tet_grid.tets) == len(grid.tets))
    log(f"[tet_unstructured] build_grid_tets({TET}) on the host: "
        f"{t_cold:.3f} s cold ({len(grid.verts)} verts, {len(grid.tets)} "
        f"tets, {len(grid.unique_edges)} unique edges), {t_cached:.3f} s "
        f"cached; the switch {t_switch:.3f} s; {UNSTRUCT_FIT_STEPS} fit steps "
        f"{t_fit:.3f} s, loss {float(out['loss'][0]):.4f} -> "
        f"{float(out['loss'][-1]):.4f}; {nv} crossings (vert cap {vcap}, "
        f"overflow {max(nv - vcap, 0)}), {nf} faces (face cap {fcap}, "
        f"overflow {max(nf - fcap, 0)}), {kept} kept; peak "
        f"{peak / 2**30:.2f} GiB {'ok' if ok else 'FAIL'}")
    log(f"[launches] tet_unstructured: raster_select {n['raster']}, "
        f"segment_sum {n['segment']}")
    if not ok:
        raise AssertionError("the unstructured tet grid phase failed its "
                             "checks")
    return n


def phase_text_to_3d(runner, tmp):
    """Text-to-3D at full width (see the module doc): two
    `run_stablessdnerf` samples of one seed, then
    `run_stablessdnerf_to_mesh` twice with one seed, called directly and
    POSTed to the port's `ApiServer` on 127.0.0.1. Returns the flash,
    raster and segment-sum launches of the two to-mesh requests."""
    import base64
    import functools
    import urllib.request

    import mvedit_tpu_torch.models.diffusion.attention as TA
    from mvedit_tpu_torch.apis import ApiServer
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          launch)
    from mvedit_tpu_torch.models.mesh import Mesh
    from mvedit_tpu_torch.utils import profiling as PR
    samples = []
    for run in ("first", "second"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.run_stablessdnerf(T23_PROMPT, seed=SEED,
                                       steps=T23_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        code, prev = out["code"].float().cpu().numpy(), out["preview"]
        size = 32 if runner.tiny else 160
        ok = (code.shape == tuple(out["ssdnerf_cfg"].latent_shape)
              and prev.shape == (size, size, 3) and np.isfinite(code).all()
              and np.isfinite(prev).all())
        log(f"[text_to_3d] run_stablessdnerf {run}: {wall:.3f} s ({T23_STEPS}"
            f" DPM-Solver++ steps of the (1, 3, 12, 40, 40) code, the 160^2 "
            f"preview); code mean |x| {float(np.abs(code).mean()):.4f}, "
            f"preview mean {float(prev.mean()):.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("run_stablessdnerf failed its checks")
        samples.append((code, prev))
    same = [bool(np.array_equal(a, b)) for a, b in zip(*samples)]
    log(f"[text_to_3d] the two samples of one seed bit-equal: code "
        f"{same[0]}, preview {same[1]}")
    if not all(same):
        raise AssertionError("two run_stablessdnerf calls of one seed differ")
    log(f"[text_to_3d] run_stablessdnerf_to_mesh: {REQ_VIEWS} views at 512^2"
        f" from the triplane (96 samples a ray), 2-pass, tet {TET}, the "
        f"distillation at its 200 steps; cut in depth: steps {REQ_STEPS} "
        f"(of 24), init_inverse_steps {REQ_INIT_INV} (of 256), "
        f"n_inverse_steps {REQ_N_INV} (of 80)")
    shapes = {}
    kernel, recording = _record_shapes(TA, shapes)
    orig = runner.run_stablessdnerf_to_mesh
    # the served request takes the runner's defaults: the cuts go in here
    runner.run_stablessdnerf_to_mesh = functools.partial(
        orig, steps=REQ_STEPS, init_inverse_steps=REQ_INIT_INV,
        n_inverse_steps=REQ_N_INV)
    server = ApiServer(runner, port=0)
    thread = server.serve(background=True)
    host, port = server.server_address
    glbs, totals = {}, dict(flash=0, raster=0, segment=0)
    try:
        for run in ("direct", "served"):
            dst = os.path.join(tmp, f"t23_{run}.glb")
            pt = PR.PhaseTimer()
            PR.set_phase_timer(pt)
            TA.flash_attention = recording
            flash_attention.launches = RS.raster_select.launches = 0
            SS.segment_sum.launches = 0
            staged = (launch.staged, RS.raster_select.staged,
                      SS.segment_sum.staged)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                if run == "direct":
                    runner.run_stablessdnerf_to_mesh(T23_PROMPT, seed=SEED,
                                                     out_path=dst)
                else:
                    req = urllib.request.Request(
                        f"http://{host}:{port}/api/"
                        "text_to_3d_stablessdnerf_to_mesh",
                        data=json.dumps({"prompt": T23_PROMPT,
                                         "seed": SEED}).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=900) as r:
                        status, answer = r.status, json.loads(r.read())
                    if status != 200:
                        raise AssertionError(f"the server answered {status}")
                    with open(dst, "wb") as f:
                        f.write(base64.b64decode(answer["mesh"]))
                torch.cuda.synchronize()
            finally:
                TA.flash_attention = kernel
                PR.set_phase_timer(None)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            n = dict(flash=flash_attention.launches,
                     raster=RS.raster_select.launches,
                     segment=SS.segment_sum.launches)
            for k in totals:
                totals[k] += n[k]
            with open(dst, "rb") as f:
                glbs[run] = f.read()
            back = Mesh.load(dst)
            ok = (len(back.f) > 0 and back.albedo is not None
                  and np.isfinite(back.albedo).all() and min(n.values()) > 0
                  and (launch.staged, RS.raster_select.staged,
                       SS.segment_sum.staged) == staged)
            log(f"[text_to_3d] {run}: {wall:.3f} s wall, peak memory "
                f"allocated {peak / 2**30:.2f} GiB; GLB {len(glbs[run])} "
                f"bytes, {len(back.f)} faces {'ok' if ok else 'FAIL'}")
            for name, sec in pt.report().items():
                log(f"[text_to_3d] {run}   part {name}: {sec:.3f} s over "
                    f"{pt.counts[name]} ticks")
            log(f"[launches] text_to_3d {run}: flash_attention "
                f"{n['flash']}, raster_select {n['raster']}, segment_sum "
                f"{n['segment']} (staged copies: none)")
            if not ok:
                raise AssertionError("the run_stablessdnerf_to_mesh request "
                                     "failed its checks")
    finally:
        runner.run_stablessdnerf_to_mesh = orig
        server.shutdown()
        thread.join(timeout=30)
    same = glbs["direct"] == glbs["served"]
    log(f"[text_to_3d] the direct and the served GLB byte-equal (one seed): "
        f"{same}")
    if not same or thread.is_alive():
        raise AssertionError("the direct and the served text-to-3D GLBs "
                             "differ, or the server did not stop")
    check_shapes("text_to_3d", shapes)
    return totals


def phase_hash_grid(runner):
    """The hash-grid field at `_mvedit_cfg`'s hash widths: one NeRF-fit
    chunk of HASH_CHUNK steps at 256^2 (LPIPS on, the request's
    schedule) on phase 7's rig and targets (the knot's `load_init_mesh`
    renders), twice from one seed, beside the dense field's chunk; then
    `triplane_ingp_point_decode` forward and backward on HYBRID_POINTS
    points at the default `TriPlaneINGPConfig`, twice. Each pair must be
    bit-equal. Returns the segment-sum launches."""
    import types
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.models import triplane as TT
    from mvedit_tpu_torch.models.fields import field_leaves, ingp_init
    from mvedit_tpu_torch.models.volume_renderer import OccupancyGrid
    from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline
    m = types.SimpleNamespace(lpips_params=runner.load_lpips())
    dense_cfg = runner._mvedit_cfg(REQ_VIEWS, REQ_STEPS, REQ_N_INV,
                                   REQ_INIT_INV)
    hcfg = dense_cfg.ingp.hash
    log(f"[hash_grid] {hcfg.n_levels} levels of 2^{hcfg.log2_hashmap_size} "
        f"rows x {hcfg.n_features}, base {hcfg.base_resolution}, max "
        f"{hcfg.max_resolution}: resolutions "
        f"{[hcfg.level_resolution(i) for i in range(hcfg.n_levels)]}")
    poses, intr, lights = _rig(SIZE)
    init = runner.load_init_mesh(torus_knot(), poses, intr, SIZE, lights)
    targets = {"images": init["images"], "masks": init["masks"],
               "poses": torch.as_tensor(poses, device=DEV),
               "intrinsics": torch.as_tensor(intr, device=DEV),
               "cam_lights": torch.as_tensor(lights, device=DEV),
               "cam_weights": torch.ones(REQ_VIEWS, device=DEV)}
    walls, tables, n_seg = {}, [], 0
    for backend in ("hash", "dense"):
        cfg = dataclasses.replace(dense_cfg, ingp=dataclasses.replace(
            dense_cfg.ingp, backend=backend))
        pipe = MVEdit3DPipeline(m, cfg)
        run, make_opt = pipe._nerf_fit_fns(256, HASH_CHUNK)
        tgt = pipe._resize_targets(targets, 256)
        secs = []
        for i in range(3):          # a warm-up, then the two compared
            gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
            field = ingp_init(cfg.ingp, gen, DEV)
            opt = make_opt(field)
            grid = OccupancyGrid.create(cfg.render.grid_size, device=DEV)
            seg0 = SS.segment_sum.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            field, _, _, out = run(field, opt, grid, tgt,
                                   sched=pipe._sched_weights(0.5, "nerf"),
                                   lpips_params=m.lpips_params,
                                   generator=gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if backend == "hash":
                n_seg += SS.segment_sum.launches - seg0
                if i:
                    tables.append([x.detach().clone()
                                   for x in field_leaves(field)])
            ok = bool(torch.isfinite(out["loss"]).all())
            if not ok:
                raise AssertionError(f"the {backend} NeRF-fit chunk gave a "
                                     f"loss that is not finite")
        walls[backend] = secs
        log(f"[hash_grid] {backend} field: a {HASH_CHUNK}-step NeRF-fit "
            f"chunk at 256^2 (LPIPS) {secs[1]:.4f} / {secs[2]:.4f} s warm "
            f"({secs[0]:.4f} s first); loss {float(out['loss'][0]):.4f} -> "
            f"{float(out['loss'][-1]):.4f}")
        del field, opt, grid, pipe
    same = all(bool(torch.equal(a, b)) for a, b in zip(*tables))
    ratio = (statistics.median(walls["hash"][1:])
             / statistics.median(walls["dense"][1:]))
    log(f"[hash_grid] the two hash chunks of one seed bit-equal (table and "
        f"MLP): {same}; segment_sum launches in the three hash chunks "
        f"{n_seg}; hash / dense chunk wall {ratio:.2f}x")
    if not same or n_seg == 0:
        raise AssertionError("two hash-grid chunks of one seed differ, or "
                             "no segment sum launched")
    # the triplane + hash hybrid at its defaults (16 x 80 x 80 planes)
    tcfg = TT.TriPlaneINGPConfig()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    params = TT.triplane_ingp_init(tcfg, gen, DEV)
    with torch.no_grad():          # a residual that is not zero
        params["ingp_base"][-1]["w"].normal_(0.0, 0.1, generator=gen)
        params["table"].mul_(1e3)
    code = torch.randn((3, tcfg.triplane.n_channels, 80, 80), generator=gen,
                       device=DEV)
    b = tcfg.triplane.bound
    xyz = torch.rand((HYBRID_POINTS, 3), generator=gen, device=DEV) \
        * (2.2 * b) - 1.1 * b
    dirs = torch.nn.functional.normalize(
        torch.randn((HYBRID_POINTS, 3), generator=gen, device=DEV), dim=-1)
    g = torch.randn((HYBRID_POINTS, 4), generator=gen, device=DEV)
    leaves = [params["table"]] + [l[k] for name in sorted(params)
                                  if name != "table"
                                  for l in params[name] for k in ("w", "b")]
    results, secs = [], []
    for _ in range(3):
        for x in leaves:
            x.requires_grad_(True)
            x.grad = None
        seg0 = SS.segment_sum.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sigma, rgb = TT.triplane_ingp_point_decode(params, code, xyz, dirs,
                                                   tcfg)
        (torch.cat([sigma[:, None], rgb], -1) * g).sum().backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        n_seg += SS.segment_sum.launches - seg0
        results.append([sigma.detach(), rgb.detach()]
                       + [x.grad.clone() for x in leaves])
    same = all(bool(torch.equal(a, b)) for a, b in zip(results[1],
                                                       results[2]))
    finite = all(bool(torch.isfinite(t).all()) for t in results[2])
    log(f"[hash_grid] triplane_ingp_point_decode forward + backward on "
        f"{HYBRID_POINTS} points: {secs[1]:.4f} / {secs[2]:.4f} s warm; "
        f"outputs and gradients bit-equal {same}, finite {finite}")
    if not (same and finite):
        raise AssertionError("the triplane + hash hybrid differs between "
                             "two runs")
    return n_seg


def write_srn_dataset(runner, root):
    """TRAIN_SCENES seeded scenes in ShapeNet SRN's layout under `root`:
    per scene TRAIN_VIEWS views of TRAIN_SIZE^2 (`srn_rig`) of the torus
    knot, turned by a seeded rotation and scaled into the 0.5 box, drawn by
    the port's mesh renderer (`load_init_mesh`, Lambert-shaded, lit from the
    camera) on white; rgb/*.png, pose/*.txt (4 x 4 c2w) and
    intrinsics.txt (focal cx cy)."""
    from PIL import Image
    knot = torus_knot(nu=KNOT_NU, nv=KNOT_NV)
    scale = 0.45 / float(np.linalg.norm(knot.v, axis=-1).max())
    for s in range(TRAIN_SCENES):
        rng = np.random.default_rng(SEED + 100 + s)
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        mesh = type(knot)(v=knot.v @ rot.T * scale, f=knot.f, vc=None)
        poses, intr = srn_rig(TRAIN_VIEWS, rng)
        light = poses[:, :3, 3] / np.linalg.norm(poses[:, :3, 3], axis=-1,
                                                 keepdims=True)
        imgs = runner.load_init_mesh(mesh, poses, intr, TRAIN_SIZE,
                                     light)["images"]
        imgs = (imgs.clamp(0, 1) * 255).round().byte().cpu().numpy()
        d = os.path.join(root, f"scene_{s:04d}")
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "pose"))
        for i in range(TRAIN_VIEWS):
            Image.fromarray(imgs[i]).save(os.path.join(d, "rgb",
                                                       f"{i:06d}.png"))
            c2w = np.eye(4)
            c2w[:3] = poses[i]
            np.savetxt(os.path.join(d, "pose", f"{i:06d}.txt"),
                       c2w.reshape(1, 16))
        with open(os.path.join(d, "intrinsics.txt"), "w") as f:
            f.write(f"{TRAIN_FOCAL} {intr[0, 2]} {intr[0, 3]} 0.\n0. 0. 0."
                    f"\n1.\n{TRAIN_SIZE} {TRAIN_SIZE}\n")


def _leaves(tree):
    from mvedit_tpu_torch.models.ssdnerf import tree_leaves
    return [x for x in tree_leaves(tree) if torch.is_tensor(x)]


def phase_training(runner, tmp):
    """SSDNeRF training at the cars recipe's widths through the CLIs (see
    the module doc). Returns the segment-sum launches of the two stage-2
    runs and their step count."""
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.models import ssdnerf as MS
    from mvedit_tpu_torch.tools import test_ssdnerf, train_ssdnerf
    data = os.path.join(tmp, "srn")
    t0 = time.perf_counter()
    write_srn_dataset(runner, data)
    log(f"[training] dataset: {TRAIN_SCENES} scenes x {TRAIN_VIEWS} views "
        f"of {TRAIN_SIZE}^2 (SRN layout, the knot on white) written in "
        f"{time.perf_counter() - t0:.3f} s")
    cfg, cfgs = TRAIN_CONFIG, {}
    for name, extra in (("stage1", "no_diffusion=True"),
                        ("stage2", "init_scene_cache='scene_cache.npz'")):
        cfgs[name] = os.path.join(tmp, f"train_{name}.py")
        with open(cfgs[name], "w") as f:
            f.write("from mvedit_tpu_torch.tools.train_ssdnerf import "
                    f"load_config\nbase = load_config({cfg!r})\n"
                    "ssdnerf_config = base.ssdnerf_config\n"
                    "build_denoiser = base.build_denoiser\n"
                    f"train_config = dict(base.train_config, {extra})\n")

    def train(config, work, *extra):
        return train_ssdnerf.main(["--config", config, "--data", data,
                                   "--work-dir", os.path.join(tmp, work),
                                   "--device", DEV, *extra])
    log(f"[training] stage 2 of ssdnerf_cars.py at its widths (4 scenes x "
        f"4096 rays x 96 samples a step, a (3, 12, 40, 40) code, the 36 -> "
        f"64 decoder, the 128-wide LatentDenoiser with EMA), "
        f"{TRAIN_STEPS} steps (of 40000), twice from seed 0")
    runs, launches = [], []
    staged = SS.segment_sum.staged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for tag in ("first", "second"):
        SS.segment_sum.launches = 0
        t0 = time.perf_counter()
        out = train(cfg, f"train_{tag}", "--max-iters", str(TRAIN_STEPS))
        wall = time.perf_counter() - t0
        launches.append(SS.segment_sum.launches)
        rl = [m["loss_render"] for m in out.metrics]
        dl = [m["loss_diffusion"] for m in out.metrics]
        step_ms = statistics.median(out.step_seconds[1:]) * 1e3
        load_ms = statistics.median(out.loader_seconds[1:]) * 1e3
        ok = (np.isfinite(rl).all() and np.isfinite(dl).all()
              and rl[-1] < rl[0] and len(rl) == TRAIN_STEPS
              and launches[-1] > 0 and SS.segment_sum.staged == staged)
        log(f"[training] {tag}: {wall:.3f} s wall; step median "
            f"{step_ms:.3f} ms (first {out.step_seconds[0] * 1e3:.3f} ms; "
            f"all: {' '.join(f'{x * 1e3:.1f}' for x in out.step_seconds)}),"
            f" loader median {load_ms:.3f} ms a batch apart (first "
            f"{out.loader_seconds[0] * 1e3:.3f}); render loss {rl[0]:.5f} "
            f"-> {rl[-1]:.5f}, diffusion loss {dl[0]:.5f} -> {dl[-1]:.5f}; "
            f"segment_sum {launches[-1]} launches "
            f"({launches[-1] / TRAIN_STEPS:.2f} a step) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {tag} training run failed its "
                                 f"checks")
        runs.append(out)
    peak = torch.cuda.max_memory_allocated()
    a, b = runs
    same = _same_runs(a, b)
    log(f"[training] peak memory allocated {peak / 2**30:.3f} GiB; the two "
        f"runs of one seed bit-equal: {same}")
    if not all(same.values()):
        raise AssertionError("two training runs of one seed differ")
    # stage 1, then stage 2 warm-started from its cache
    s1 = train(cfgs["stage1"], "train_stages", "--max-iters", "2")
    s2 = train(cfgs["stage2"], "train_stages", "--max-iters", "2")
    touched = s1.cache.steps > 0
    ok = ("denoiser" not in s1.trainer.state and touched.any()
          and bool((s2.cache.steps[touched] >= 1).all())
          and (s2.cache.steps > s1.cache.steps).any()
          and np.isfinite([m["loss_render"] for m in s1.metrics
                           + s2.metrics]).all())
    log(f"[training] stage 1 (2 steps, render loss "
        f"{s1.metrics[-1]['loss_render']:.5f}) then stage 2 warm-started "
        f"from its cache (2 steps, diffusion loss "
        f"{s2.metrics[-1]['loss_diffusion']:.5f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the two-stage run failed its checks")
    # resume the first run with the eval hook on
    res = train(cfg, "train_first", "--resume", "--max-iters",
                str(TRAIN_STEPS + 2), "--eval-interval", "2",
                "--eval-scenes", str(TRAIN_EVAL_SCENES))
    with open(os.path.join(tmp, "train_first", "eval.jsonl")) as f:
        evals = [json.loads(r) for r in f]
    ok = (res.trainer.step == TRAIN_STEPS + 2 and len(res.metrics) == 2
          and [r["step"] for r in evals] == [TRAIN_STEPS + 2] * 2
          and all(np.isfinite(r["psnr"]) for r in evals)
          and int(res.trainer.state["decoder_opt"]["count"])
          == TRAIN_STEPS + 2)
    log(f"[training] resume from step {TRAIN_STEPS} to {TRAIN_STEPS + 2} "
        f"with the eval hook: PSNR {evals[-1]['psnr']:.3f} on view 0 of "
        f"{TRAIN_EVAL_SCENES} scenes {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the resumed run failed its checks")
    # the recons eval: val_optim on view 0, PSNR / SSIM on view 1
    make, walls = MS.make_val_optim, []

    def timed_make(*a, **k):
        fn = make(*a, **k)

        def run(*a2, **k2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a2, **k2)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out
        return run
    MS.make_val_optim = timed_make
    SS.segment_sum.launches = 0
    try:
        got = test_ssdnerf.main(["--config", cfg, "--data", data,
                                 "--work-dir", os.path.join(tmp,
                                                            "train_first"),
                                 "--device", DEV, "--num-scenes",
                                 str(TRAIN_EVAL_SCENES), "--recons-views",
                                 "1"])
    finally:
        MS.make_val_optim = make
    ok = (got["scenes"] == TRAIN_EVAL_SCENES and np.isfinite(got["psnr"])
          and len(walls) == TRAIN_EVAL_SCENES
          and SS.segment_sum.launches > 0)
    log(f"[training] test_ssdnerf --recons-views 1: PSNR {got['psnr']:.3f},"
        f" SSIM {got['ssim']:.4f} over {got['scenes']} scenes; val_optim "
        f"(100 steps on {TRAIN_SIZE}^2 rays) "
        f"{' / '.join(f'{w:.3f}' for w in walls)} s a scene; segment_sum "
        f"{SS.segment_sum.launches} launches {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the recons eval failed its checks")
    return dict(segment=sum(launches), steps=2 * TRAIN_STEPS,
                step_ms=statistics.median(a.step_seconds[1:]
                                          + b.step_seconds[1:]) * 1e3,
                peak_gib=peak / 2**30)


def _train_runs(train, config, work, steps, tag, runs=1):
    """`runs` runs of `train_ssdnerf.main` from seed 0 with the segment
    sums counted; each run's step / loader medians (its first step
    apart), losses and launches printed. Returns the runs' outputs, their
    launches and the peak memory over them."""
    from mvedit_tpu_torch.kernels import segment_sum as SS
    outs, launches = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for r in range(runs):
        SS.segment_sum.launches = 0
        t0 = time.perf_counter()
        out = train(config, f"{work}_{r}", "--max-iters", str(steps))
        wall = time.perf_counter() - t0
        launches.append(SS.segment_sum.launches)
        rl = [m["loss_render"] for m in out.metrics]
        dl = [m.get("loss_diffusion", 0.0) for m in out.metrics]
        step_ms = statistics.median(out.step_seconds[1:]) * 1e3
        load_ms = statistics.median(out.loader_seconds[1:]) * 1e3
        ok = (np.isfinite(rl).all() and np.isfinite(dl).all()
              and len(rl) == steps and launches[-1] > 0)
        log(f"[{tag}] run {r + 1}: {wall:.3f} s wall; step median "
            f"{step_ms:.3f} ms (first {out.step_seconds[0] * 1e3:.3f}; all "
            f"{' '.join(f'{x * 1e3:.1f}' for x in out.step_seconds)}), "
            f"loader median {load_ms:.3f} ms a batch (first "
            f"{out.loader_seconds[0] * 1e3:.3f}); render loss a step "
            f"{' '.join(f'{x:.5f}' for x in rl)}; diffusion loss "
            f"{' '.join(f'{x:.5f}' for x in dl)}; segment_sum "
            f"{launches[-1]} launches {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: run {r + 1} failed its checks")
        outs.append(out)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] peak memory allocated {peak / 2**30:.3f} GiB")
    return outs, launches, peak


def _same_runs(a, b):
    """Bit-equality of two stage-2 runs' code caches (codes, moments,
    steps), decoders, denoisers, their optimizer states and EMAs."""
    return dict(
        codes=all(np.array_equal(getattr(a.cache, k), getattr(b.cache, k))
                  for k in ("codes", "m", "v", "steps")),
        **{k: all(bool(torch.equal(x, y)) for x, y in zip(
            _leaves(a.trainer.state[k]), _leaves(b.trainer.state[k])))
           for k in ("decoder", "decoder_opt", "denoiser", "denoiser_opt")},
        ema=all(bool(torch.equal(x, y)) for x, y in zip(_leaves(a.ema),
                                                         _leaves(b.ema))))


def phase_stablessdnerf(tmp):
    """StableSSDNeRF training at full width (`mvedit_tpu_torch/configs/
    stablessdnerf_cars_lpips.py`: the seeded SD2.1 UNet frozen with a
    rank-32 LoRA, the 23-layer 1024-wide CLIP on seeded captions, 8 scenes
    x one 32 x 32 patch x 96 samples with LPIPS) on phase 19's dataset,
    through `tools/train_ssdnerf.main` (what `python -m` runs) twice from
    one seed, then one `tools/test_ssdnerf` recons eval. Returns the
    segment-sum launches and the step / peak numbers."""
    import pickle

    from mvedit_tpu_torch.configs import stablessdnerf_cars_lpips as S
    from mvedit_tpu_torch.kernels.flash_attention import flash_attention
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.tools import test_ssdnerf, train_ssdnerf
    data = os.path.join(tmp, "srn")
    rng = np.random.default_rng(SEED + 20)
    words = ["red", "blue", "silver", "old", "sports", "pickup", "convertible",
             "station", "wagon", "racing", "car", "truck", "with", "stripes"]
    caps = {f"scene_{s:04d}": " ".join(rng.choice(words, 6))
            for s in range(TRAIN_SCENES)}
    cap_path = os.path.join(tmp, "captions.pkl")
    with open(cap_path, "wb") as f:
        pickle.dump(caps, f)
    cfg = os.path.join(tmp, "stablessdnerf.py")
    with open(cfg, "w") as f:
        f.write("from mvedit_tpu_torch.configs.stablessdnerf_cars_lpips "
                "import (ssdnerf_config, train_config, build_denoiser, "
                f"make_cond_fn)\ncaptions = {cap_path!r}\n")
    built, real = [], S.build_denoiser

    def build(*a, **k):
        # the frozen base as built, on the host, to compare after the run
        net = real(*a, **k)
        built.append((net, {n: v.cpu() for n, v in
                            net.unet.state_dict().items()}))
        return net

    def train(config, work, *extra):
        return train_ssdnerf.main(["--config", config, "--data", data,
                                   "--work-dir", os.path.join(tmp, work),
                                   "--device", DEV, *extra])
    log(f"[stablessdnerf] SD2.1 UNet (frozen, f32 weights, bf16 compute) + "
        f"rank-32 LoRA, the 1024-wide 23-layer CLIP on captions, 8 scenes x "
        f"a 32^2 patch x 96 samples, LPIPS 1.2; {LORA_STEPS} steps (of "
        f"100000), twice from seed 0")
    flash_attention.launches = 0
    S.build_denoiser = build
    try:
        outs, launches, peak = _train_runs(train, cfg, "lora", LORA_STEPS,
                                           "stablessdnerf", runs=2)
    finally:
        S.build_denoiser = real
    net, base0 = built[0]
    n_lora = sum(v.numel() for v in outs[0].trainer.state[
        "denoiser"].values())
    n_base = sum(v.numel() for v in base0.values())
    keys_ok = all(k.startswith("lora.") for k in outs[0].trainer.state[
        "denoiser"])
    base_same = all(bool(torch.equal(v.cpu(), base0[n]))
                    for n, v in net.unet.state_dict().items())
    same = _same_runs(*outs)
    log(f"[stablessdnerf] LoRA {n_lora} parameters in the state "
        f"({len(outs[0].trainer.state['denoiser'])} tensors, all LoRA: "
        f"{keys_ok}) beside {n_base} frozen; the frozen base bit-equal to "
        f"its initial value after the run: {base_same}; the two runs of one "
        f"seed bit-equal: {same}; flash launches {flash_attention.launches} "
        f"(the maps' 4800 / 1200 tokens are no multiple of 128)")
    if not (keys_ok and base_same and all(same.values())):
        raise AssertionError("the LoRA recipe's state, base or runs differ")
    del built[:], net, base0
    torch.cuda.empty_cache()
    SS.segment_sum.launches = 0
    t0 = time.perf_counter()
    got = test_ssdnerf.main(["--config", cfg, "--data", data, "--work-dir",
                             os.path.join(tmp, "lora_0"), "--device", DEV,
                             "--num-scenes", "1", "--recons-views", "1",
                             "--recons-steps", str(LORA_RECONS_STEPS)])
    wall = time.perf_counter() - t0
    ok = got["scenes"] == 1 and np.isfinite(got["psnr"]) \
        and SS.segment_sum.launches > 0
    log(f"[stablessdnerf] test_ssdnerf --recons-views 1 on 1 scene "
        f"({LORA_RECONS_STEPS} val_optim steps of 100, the LoRA UNet's "
        f"prior on): PSNR {got['psnr']:.3f}, SSIM {got['ssim']:.4f}, "
        f"{wall:.3f} s with the models' build; segment_sum "
        f"{SS.segment_sum.launches} launches {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the LoRA recipe's recons eval failed")
    steps = [x for o in outs for x in o.step_seconds[1:]]
    return dict(segment=sum(launches), steps=2 * LORA_STEPS,
                step_ms=statistics.median(steps) * 1e3,
                loader_ms=statistics.median(
                    [x for o in outs for x in o.loader_seconds[1:]]) * 1e3,
                peak_gib=peak / 2**30, lora_params=n_lora)


def phase_paper_family(tmp):
    """The paper family at its (3, 6, 128, 128) code on phase 19's 8
    scenes: stage 1 with the filesystem cache, the stack recipe twice from
    one seed (bit-equal), the tiled recipe (ch 80, 16 groups)."""
    from mvedit_tpu_torch.tools import train_ssdnerf
    data = os.path.join(tmp, "srn")

    def train(config, work, *extra):
        return train_ssdnerf.main(["--config", config, "--data", data,
                                   "--work-dir", os.path.join(tmp, work),
                                   "--device", DEV, *extra])
    res, seg = {}, 0
    for name, runs in (("stage1_cars_recons16v_16bit_filesystem", 1),
                       ("ssdnerf_cars_recons1v", 2),
                       ("ssdnerf_cars_recons1v_tiled", 1)):
        log(f"[paper] {name}: 8 scenes x 4096 rays x 96 samples, a (3, 6, "
            f"128, 128) code, {PAPER_STEPS} steps, {runs} run(s) from seed 0")
        outs, launches, peak = _train_runs(
            train, os.path.join(CONFIGS, name + ".py"), name, PAPER_STEPS,
            "paper", runs=runs)
        seg += sum(launches)
        if runs == 2:
            same = _same_runs(*outs)
            log(f"[paper] {name}: two runs of one seed bit-equal: {same}")
            if not all(same.values()):
                raise AssertionError(f"{name}: two runs of one seed differ")
        if name.startswith("stage1"):
            outs[0].cache.close()   # the filesystem cache's writers
        res[name] = dict(step_ms=statistics.median(
            [x for o in outs for x in o.step_seconds[1:]]) * 1e3,
            loader_ms=statistics.median(
                [x for o in outs for x in o.loader_seconds[1:]]) * 1e3,
            peak_gib=peak / 2**30)
    return dict(segment=seg, runs=res)


def _agree(a, b):
    """(relative L2 distance, both finite) of a card tensor to a CPU one."""
    a = a.detach().double().cpu()
    b = b.detach().double()
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    return float((a - b).norm() / b.norm().clamp(min=1e-300)), finite


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_modules(tmp):
    """The module-only ports on the card at their default widths, each held
    to the same module on the CPU in f32 (TF32 off on the card for the
    comparison: convolutions and matmuls in f32 on both): Inception
    features and `inception_stat`, DDPMUNet forward and backward,
    UNetVolume and the masked ResnetBlockVolume, the sparse
    interpolations with their gradients."""
    import copy

    from mvedit_tpu_torch.models.ddpm_unet import DDPMUNet, DDPMUNetConfig
    from mvedit_tpu_torch.models import volume_unet as V
    from mvedit_tpu_torch.ops import volume_interp as VI
    from mvedit_tpu_torch.tools import inception_stat
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 22)
    rows, failed = [], []

    def check(name, pairs, wall, tol):
        errs = [_agree(a, b) for a, b in pairs]
        ok = all(f and e <= tol for e, f in errs)
        log(f"[modules] {name}: {wall:.4f} s on the card (warm); relative "
            f"L2 to the CPU f32 run {' '.join(f'{e:.2e}' for e, _ in errs)} "
            f"(tolerance {tol:g}), finite {all(f for _, f in errs)} "
            f"{'ok' if ok else 'FAIL'}")
        rows.append(dict(name=name, wall_s=wall,
                         errs=[e for e, _ in errs]))
        if not ok:
            failed.append(name)
    try:
        # InceptionV3 on 32 images; the CPU holds the first 8 of them
        net = inception_stat.load_inception(None, torch.device(DEV))
        x = torch.rand((32, 3, 299, 299), generator=gen)
        xd = x.to(DEV)
        with torch.no_grad():
            net(xd)                      # warm: cuDNN picks its algorithms
            feats, wall = _timed(lambda: net(xd))
            ref = copy.deepcopy(net).cpu()(x[:8])
        check("InceptionV3Features (32 x 299^2 -> 2048)",
              [(feats[:8], ref)], wall, 1e-4)
        stat, wall = _timed(lambda: inception_stat.main(
            ["--data", os.path.join(tmp, "srn"), "--out",
             os.path.join(tmp, "inception.npz"), "--device", DEV,
             "--views-per-scene", "8"]))
        ok = stat["feats"].shape == (TRAIN_SCENES * min(8, TRAIN_VIEWS),
                                     2048) and \
            np.isfinite(stat["sigma"]).all()
        log(f"[modules] inception_stat over phase 19's dataset "
            f"({TRAIN_SCENES} scenes x 8 views, 128^2 -> 299^2): "
            f"{stat['feats'].shape} features, mu / sigma finite, {wall:.3f} "
            f"s with the build {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append("inception_stat")
        del net, feats, ref
        # DDPMUNet at its defaults on a (2, 3, 12, 40, 40) code
        cfg = DDPMUNetConfig()
        cpu = DDPMUNet(cfg)
        from mvedit_tpu_torch.apis.runner import init_random_
        with torch.no_grad():
            init_random_(cpu, gen)
        card = copy.deepcopy(cpu).to(DEV)
        x = torch.randn((2, 3, 12, 40, 40), generator=gen)
        t = torch.tensor([17, 802])
        w = torch.randn(x.shape, generator=gen)

        def fwd_bwd(net, dev):
            xi = x.to(dev, copy=True).requires_grad_(True)
            out = net(xi, t.to(dev))
            (out * w.to(dev)).sum().backward()
            return out, xi.grad
        fwd_bwd(card, DEV)
        card.zero_grad(set_to_none=True)
        (out, gx), wall = _timed(lambda: fwd_bwd(card, DEV))
        rout, rgx = fwd_bwd(cpu, "cpu")
        pg = [(p.grad, q.grad) for p, q in zip(card.parameters(),
                                              cpu.parameters())]
        worst = max(pg, key=lambda pq: _agree(*pq)[0])
        check("DDPMUNet(DDPMUNetConfig()) forward + backward on (2, 3, 12, "
              "40, 40): output, input gradient, worst parameter gradient",
              [(out, rout), (gx, rgx), worst], wall, 1e-4)
        del card, cpu, out, gx
        # UNetVolume at its defaults on a masked 32^3 volume, forward;
        # the masked ResnetBlockVolume at its first width
        vcfg = V.VolumeUNetConfig(out_channels=4)
        cpu = V.init_volume_unet_(V.UNetVolume(vcfg), gen)
        card = copy.deepcopy(cpu).to(DEV)
        mask = torch.rand((1, 32, 32, 32), generator=gen) < 0.3
        vol = torch.randn((1, 4, 32, 32, 32), generator=gen) * mask[:, None]
        vd = vol.to(DEV)
        with torch.no_grad():
            card(vd)
            (out, _), wall = _timed(lambda: card(vd))
            rout, _ = cpu(vol)
        check("UNetVolume(VolumeUNetConfig(out_channels=4)) on a masked "
              "32^3 volume", [(out, rout)], wall, 1e-4)
        blk = V.init_volume_unet_(V.ResnetBlockVolume(320, 320), gen)
        with torch.no_grad():
            blk.conv2.weight.normal_(0, 0.01, generator=gen)
        bcard = copy.deepcopy(blk).to(DEV)
        h = torch.randn((1, 320, 32, 32, 32), generator=gen) * mask[:, None]
        hd, md = h.to(DEV), mask.to(DEV)
        with torch.no_grad():
            bcard(hd, md)
            out, wall = _timed(lambda: bcard(hd, md))
            rout = blk(h, mask)
        check("masked ResnetBlockVolume(320) on the 32^3 mask",
              [(out, rout)], wall, 1e-4)
        del card, cpu, out, bcard, blk
        # the sparse interpolations: a 64^3 volume, ~40% active, 10^6
        # points, the gradients to the features and the points
        grid = torch.stack(torch.meshgrid(
            *[torch.arange(n) for n in (1, 64, 64, 64)], indexing="ij"),
            -1).reshape(-1, 4)
        keep = torch.rand(grid.shape[0], generator=gen) < 0.4
        idx = grid[keep]
        feats = torch.randn((idx.shape[0], 8), generator=gen)
        pts = torch.rand((1 << 20, 3), generator=gen) * 2.2 - 1.1
        bi = torch.zeros((pts.shape[0], 1), dtype=torch.int32)
        wp = torch.randn((pts.shape[0], 8), generator=gen)
        for nb in (False, True):
            fn = VI.neighbor_spvolume_linear_interp if nb else \
                VI.spvolume_linear_interp

            def run(dev):
                f = feats.to(dev, copy=True).requires_grad_(True)
                p = pts.to(dev, copy=True).requires_grad_(True)
                v = VI.sparse_volume(idx.to(dev), f, (64, 64, 64), 1)
                out, valid = fn(v, p, bi.to(dev))
                (out * wp.to(dev)).sum().backward()
                return out, valid, f.grad, p.grad
            run(DEV)
            (out, valid, gf, gp), wall = _timed(lambda: run(DEV))
            rout, rvalid, rgf, rgp = run("cpu")
            same_valid = bool(torch.equal(valid.cpu(), rvalid))
            log(f"[modules] {'neighbor_' if nb else ''}spvolume_linear_"
                f"interp: {idx.shape[0]} active voxels, {pts.shape[0]} "
                f"points ({int(valid.sum())} valid, the masks equal "
                f"{same_valid})")
            check(f"{'neighbor_' if nb else ''}spvolume_linear_interp "
                  f"forward + backward: output, features' and points' "
                  f"gradients", [(out, rout), (gf, rgf), (gp, rgp)], wall,
                  1e-5)
            if not same_valid:
                failed.append("interp valid mask")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if failed:
        raise AssertionError(f"module ports disagree with the CPU: {failed}")
    return rows


def _knot_views(n_views, size):
    """n_views of the knot at size^2 through the port's renderer, from a
    surround rig at distance 2.5 and 40 degrees of view (the whole knot in
    frame): (c2w (N, 3, 4), intrinsics (N, 4), rgb (N, H, W, 3) its
    normals on white, alpha (N, H, W), camera-space depth z (N, H, W), 0
    where nothing covers). The knot's tube at 400 x 48 (38400 faces) and
    the mesh fit's raster config (K 1024), so that no tile drops faces:
    the 250k-face knot at 512^2 overflows every tile's list."""
    from mvedit_tpu_torch.apis.cameras import surround_rig
    from mvedit_tpu_torch.models.mesh import RasterConfig, render_views
    knot = torus_knot(nu=RGBD_NU, nv=RGBD_NV)
    poses, intr = surround_rig(n_views, 2.5, 40, -0.6, 0.6, size,
                               rng=np.random.default_rng(SEED))
    poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32,
                            device=DEV)
    intr = torch.as_tensor(np.asarray(intr), dtype=torch.float32,
                           device=DEV)
    faces = torch.as_tensor(knot.f, dtype=torch.int64, device=DEV)
    with torch.no_grad():
        out = render_views(torch.as_tensor(knot.v, device=DEV), faces,
                           torch.ones(faces.shape[0], dtype=torch.bool,
                                      device=DEV),
                           poses, intr, RasterConfig(
                               height=size, width=size, span=2,
                               k_per_tile=1024, k_big=64))
    a = out["alpha"]
    rgb = (out["normal"] * 0.5 + 0.5) * a + (1 - a)
    depth = torch.where(out["alpha_hard"][..., 0] > 0, out["depth"],
                        torch.zeros((), device=DEV))
    return poses, intr, rgb.clamp(0, 1), a[..., 0], depth


def _w2c(pose):
    from mvedit_tpu_torch.models.mesh import pose_to_w2c
    return pose_to_w2c(pose)


def phase_grm():
    """GRM and the gaussian renderer at full width (see the module doc):
    the seeded GRMConfig() encoder and the upsampler on GRM_VIEWS views of
    the knot, 2^20 gaussians rendered at GSRasterConfig(512, 512) and
    fitted with GRM_ADAM_STEPS Adam steps against the views, twice with
    one seed. Returns the flash launches at GRM_SHAPE, the segment-sum
    launches and the times."""
    import mvedit_tpu_torch.models.diffusion.attention as TA
    from mvedit_tpu_torch.apis.runner import init_random_
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          launch)
    from mvedit_tpu_torch.models.grm import (GaussianUpsampler, GRMConfig,
                                             GRMEncoder, pixels_to_gaussians,
                                             plucker_rays)
    from mvedit_tpu_torch.models.mesh.gaussians import (GSRasterConfig,
                                                        render_gaussians)
    poses, intr, images, _, _ = _knot_views(GRM_VIEWS, SIZE)
    cfg = GSRasterConfig(SIZE, SIZE)
    names = ("means", "scales", "quats", "colors", "opacities")

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def run():
        gen = torch.Generator(device=DEV).manual_seed(SEED + 23)
        gcfg = GRMConfig()
        with torch.device(DEV):
            enc, up = GRMEncoder(gcfg), GaussianUpsampler(gcfg.dim,
                                                          gcfg.out_channels)
        for net in (enc, up):
            init_random_(net, gen).eval().requires_grad_(False)
        shapes = {}
        kernel, recording = _record_shapes(TA, shapes)
        TA.flash_attention = recording
        fa0, staged0 = flash_attention.launches, launch.staged
        try:
            with torch.no_grad():
                plk = plucker_rays(poses, intr, SIZE, SIZE)
                feat, t_enc = sync_time(lambda: enc(images, plk))
                pm, t_up = sync_time(lambda: up(feat))
                g = pixels_to_gaussians(pm, poses, intr)
        finally:
            TA.flash_attention = kernel
        n = dict(flash=flash_attention.launches - fa0,
                 staged=launch.staged - staged0, shapes=shapes)
        attrs = [g[k].detach().clone().requires_grad_(True) for k in names]
        opt = torch.optim.Adam(attrs, lr=1e-3)
        seg0 = SS.segment_sum.launches
        torch.cuda.reset_peak_memory_stats()
        grads, t_fwd, t_bwd = None, [], []
        for step in range(GRM_ADAM_STEPS):
            opt.zero_grad(set_to_none=True)
            for v in range(GRM_VIEWS):
                out, tf = sync_time(lambda: render_gaussians(
                    *attrs, _w2c(poses[v]), intr[v], cfg))
                loss = (out["rgb"] - images[v]).abs().mean() / GRM_VIEWS
                _, tb = sync_time(loss.backward)
                t_fwd.append(tf)
                t_bwd.append(tb)
            if step == 0:
                grads = [a.grad.clone() for a in attrs]
            opt.step()
        n["segment"] = SS.segment_sum.launches - seg0
        with torch.no_grad():
            renders = [render_gaussians(*attrs, _w2c(poses[v]), intr[v], cfg)
                       for v in range(GRM_VIEWS)]
        torch.cuda.synchronize()
        return dict(feat=feat, renders=renders, attrs=attrs, grads=grads,
                    n=n, times=dict(encoder=t_enc, upsampler=t_up,
                                    render_fwd=statistics.median(t_fwd),
                                    render_bwd=statistics.median(t_bwd)),
                    peak=torch.cuda.max_memory_allocated(),
                    loss=loss.item() * GRM_VIEWS, n_gauss=len(attrs[0]))

    a, b = run(), run()
    same = dict(
        renders=all(torch.equal(x[k], y[k]) for x, y in
                    zip(a["renders"], b["renders"]) for k in x),
        attrs=all(torch.equal(x, y) for x, y in zip(a["attrs"], b["attrs"])),
        grads=all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])),
        feat=bool(torch.equal(a["feat"], b["feat"])))
    finite = all(bool(torch.isfinite(r[k]).all()) for r in a["renders"]
                 for k in r) and all(bool(torch.isfinite(x).all())
                                     for x in a["grads"])
    grm_calls = a["n"]["shapes"].get(GRM_SHAPE, 0)
    ok = (all(same.values()) and finite and grm_calls > 0
          and a["n"]["segment"] > 0 and a["n"]["staged"] == 0
          and a["n_gauss"] == GRM_VIEWS * SIZE * SIZE)
    t = a["times"]
    log(f"[grm] GRMConfig() (dim 512, depth 12, heads 8, patch 8) on "
        f"{GRM_VIEWS} knot views of {SIZE}^2: {a['n_gauss']} gaussians; "
        f"encoder {t['encoder']:.4f} s, upsampler {t['upsampler']:.4f} s "
        f"(the first run's cold, the second's warm: "
        f"{b['times']['encoder']:.4f} / {b['times']['upsampler']:.4f} s), "
        f"one render forward {t['render_fwd']:.4f} s and backward "
        f"{t['render_bwd']:.4f} s (medians of the fit's "
        f"{GRM_ADAM_STEPS * GRM_VIEWS}; GSRasterConfig({SIZE}, {SIZE}): tile "
        f"16, K 256); {GRM_ADAM_STEPS} Adam steps x {GRM_VIEWS} views, "
        f"last L1 {a['loss']:.4f}; peak {a['peak'] / 2**30:.2f} GiB in the "
        f"fit; two runs bit-equal {same}, finite {finite} "
        f"{'ok' if ok else 'FAIL'}")
    log(f"[launches] grm: flash_attention {a['n']['flash']} (at "
        f"{GRM_SHAPE}: {grm_calls}; staged {a['n']['staged']}), "
        f"segment_sum {a['n']['segment']} in the fit (one a render "
        f"backward)")
    check_shapes("grm", a["n"]["shapes"])
    if not ok:
        raise AssertionError("the GRM / gaussian phase failed its checks")
    return dict(flash=a["n"]["flash"] + b["n"]["flash"],
                grm_calls=grm_calls + b["n"]["shapes"].get(GRM_SHAPE, 0),
                segment=a["n"]["segment"] + b["n"]["segment"],
                **b["times"])


def phase_tsdf(runner, req_ctx):
    """TSDF fusion and marching cubes (see the module doc): TSDF_VIEWS
    RGB-D views of the knot into `tsdf_rgbd_to_mesh` at its defaults,
    twice, the integration on the card and the extraction on the host
    timed apart; then `extract_geometry` on phase 7's fitted field."""
    from scipy.spatial import cKDTree
    import mvedit_tpu_torch.models.mesh.tsdf as TT
    from mvedit_tpu_torch.models.fields import ingp_point_decode
    from mvedit_tpu_torch.ops.marching_cubes import extract_geometry
    poses, intr, rgb, alpha, depth = _knot_views(TSDF_VIEWS, SIZE)
    c2w = torch.cat([poses, torch.tensor([[[0.0, 0, 0, 1]]], device=DEV)
                     .expand(len(poses), 1, 4)], 1)
    parts = {}

    def timed(name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return wrapped
    saved = TT.tsdf_integrate, TT.tsdf_to_mesh
    TT.tsdf_integrate = timed("integrate", saved[0])
    TT.tsdf_to_mesh = timed("extract", saved[1])
    try:
        meshes = [TT.tsdf_rgbd_to_mesh(rgb, depth, c2w, intr,
                                       voxel_resolution=TSDF_RES)
                  for _ in range(2)]
    finally:
        TT.tsdf_integrate, TT.tsdf_to_mesh = saved
    m = meshes[0]
    same = {k: bool(np.array_equal(getattr(meshes[0], k),
                                   getattr(meshes[1], k)))
            for k in ("v", "f", "vc")}
    # distance of the vertices to the knot: to its centre line, less the
    # tube radius
    centre = torus_knot(nu=200000, nv=3).v.reshape(200000, 3, 3).mean(1)
    # the rendered tube is a 48-gon: its flat sides lie inside the circle
    tube = 0.09 * np.cos(np.pi / RGBD_NV)
    d = np.abs(cKDTree(centre).query(m.v)[0] - tube) if len(m.v) else \
        np.array([np.inf])
    voxel = 2.0 / TSDF_RES
    med = float(np.median(d))
    ok = all(same.values()) and len(m.f) > 0 and med <= 2 * voxel
    log(f"[tsdf] tsdf_rgbd_to_mesh of {TSDF_VIEWS} knot views at {SIZE}^2 "
        f"(voxel_resolution {TSDF_RES}, prune_thr 800, mesh_reduction "
        f"0.2): {len(m.v)} verts, {len(m.f)} faces; integration on the "
        f"card " + ", ".join(f"{x:.4f}" for x in parts["integrate"])
        + " s; extraction on the host " + ", ".join(
            f"{x:.4f}" for x in parts["extract"]) + f" s; median vertex "
        f"distance to the knot {med:.5f} ({med / voxel:.3f} voxels, at most "
        f"2), 90th percentile {float(np.percentile(d, 90)):.5f}; two runs "
        f"bit-equal {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the TSDF phase failed its checks")
    cfg = runner._mvedit_cfg(REQ_VIEWS, REQ_STEPS, REQ_N_INV, REQ_INIT_INV)
    field = req_ctx["out"]["nerf_params"]
    lo, hi = [], []

    def density(x):
        d = ingp_point_decode(field, x, cfg.ingp)[0]
        lo.append(float(d.min()))
        hi.append(float(d.max()))
        return d
    # at the reference's threshold, then (the grid cached) midway through
    # the field's density range, which the seeded field's fit keeps low
    runs = []
    for thr in (10.0, None):
        thr = thr if thr is not None else 0.5 * (min(lo) + max(hi))
        t0 = time.perf_counter()
        with torch.no_grad():
            v, f = extract_geometry(density, resolution=EXTRACT_RES,
                                    threshold=thr, device=DEV)
        runs.append((thr, len(v), len(f), time.perf_counter() - t0))
        if not (np.isfinite(v).all() and (len(f) == 0
                                          or f.max() < len(v))):
            raise AssertionError("extract_geometry failed its checks")
    ok = runs[1][2] > 0
    log(f"[tsdf] extract_geometry of phase 7's fitted field at "
        f"{EXTRACT_RES} (the grid built or read from its cache on the "
        f"host, the density in chunks on the card, the compaction on the "
        f"host); density {min(lo):.4f} to {max(hi):.4f}: " + "; ".join(
            f"threshold {thr:.4f}: {nv} verts, {nf} faces in {sec:.3f} s"
            for thr, nv, nf, sec in runs) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("extract_geometry found no surface")
    t_ex = runs[0][3]
    return dict(integrate=parts["integrate"], extract=parts["extract"],
                faces=len(m.f), extract_geometry_s=t_ex)


def phase_sharded(runner, req_ctx):
    """Sharding at world size 1 over NCCL (see the module doc): the
    sharded CFG step, NeRF step and mesh-fit chunk against their unsharded
    counterparts, bit for bit, then one `run_3d_to_3d` at phase 7's
    settings with `device_mesh` set, whose views and GLB must be phase 7's
    first request's. Returns the flash and segment-sum launches."""
    import socket
    import tempfile
    from functools import partial

    import torch.distributed as dist

    import mvedit_tpu_torch.models.diffusion.attention as TA
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import flash_attention
    from mvedit_tpu_torch.models.diffusion import AttnMode
    from mvedit_tpu_torch.models.fields import ingp_point_decode
    from mvedit_tpu_torch.models.volume_renderer import render_rays
    from mvedit_tpu_torch.parallel import (make_mesh,
                                           make_sharded_denoise_step,
                                           make_sharded_nerf_step)
    from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline
    from mvedit_tpu_torch.utils.geometry import get_ray_directions, get_rays
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    fa0, seg0 = flash_attention.launches, SS.segment_sum.launches
    times = {}

    def sync_time(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    try:
        mesh = make_mesh()
        # the CFG step on 2 x SHARD_VIEWS images of 512^2 at SD1.5 widths
        m = runner.load_stable_diffusion()
        gen = torch.Generator(device=DEV).manual_seed(SEED + 25)
        N = SHARD_VIEWS
        lat = torch.randn((2 * N, SIZE // 8, SIZE // 8, 4), generator=gen,
                          device=DEV)
        t = torch.full((2 * N,), 500, dtype=torch.int32, device=DEV)
        pos, neg = runner.encode_prompt(m, ["a golden torus knot"] * N,
                                        [""] * N)
        ctx = torch.cat([neg, pos], 0)
        mode = AttnMode(num_views=N)
        shapes = {}
        kernel, recording = _record_shapes(TA, shapes)
        TA.flash_attention = recording
        try:
            step = make_sharded_denoise_step(m.unet, mesh, mode, GS)

            def plain():
                with torch.inference_mode():
                    u, c = m.unet(lat, t, ctx, mode=mode).chunk(2, 0)
                    g = u + GS * (c - u)
                    return torch.cat([g, g], 0)
            # in turns, the first of each cold
            for _ in range(2):
                sharded = sync_time("denoise_sharded",
                                    lambda: step(lat, t, ctx))
                ref = sync_time("denoise_plain", plain)
        finally:
            TA.flash_attention = kernel
        check_shapes("sharded", shapes)
        same = dict(denoise=bool(torch.equal(sharded, ref)))

        # the NeRF step on phase 7's dense field, a 128^2 patch of a view
        cfg = runner._mvedit_cfg(REQ_VIEWS, REQ_STEPS, REQ_N_INV,
                                 REQ_INIT_INV)
        poses, intr, images, _, _ = _knot_views(1, SIZE)
        dirs = get_ray_directions(SIZE, SIZE, intr[0])
        ro, rd = get_rays(dirs, poses[0], norm=True)
        h = min(64, SIZE // 4)
        sl = (slice(SIZE // 2 - h, SIZE // 2 + h),) * 2
        ro, rd = ro[sl].reshape(-1, 3), rd[sl].reshape(-1, 3)
        target = images[0][sl].reshape(-1, 3)
        decode = partial(ingp_point_decode, cfg=cfg.ingp)
        src = req_ctx["out"]["nerf_params"]

        def fresh():
            return {"table": {k: v.detach().clone() for k, v in
                              src["table"].items()},
                    "mlp": [{k: v.detach().clone() for k, v in l.items()}
                            for l in src["mlp"]]}
        nstep, make_opt = make_sharded_nerf_step(decode, cfg.render, mesh)
        p1 = fresh()
        p1, _, loss1 = sync_time("nerf_sharded", lambda: nstep(
            p1, make_opt(p1), ro, rd, target))
        p2 = fresh()
        opt2 = make_opt(p2)

        def plain_nerf():
            opt2.zero_grad(set_to_none=True)
            out = render_rays(partial(decode, p2), ro, rd, cfg.render,
                              bg_color=1.0)
            loss = (out["rgb"] - target).abs().mean()
            loss.backward()
            for q in opt2.param_groups[0]["params"]:
                if q.grad is None:
                    q.grad = torch.zeros_like(q)
            opt2.step()
            return loss.detach()
        loss2 = sync_time("nerf_plain", plain_nerf)
        from mvedit_tpu_torch.models.fields import field_leaves
        same["nerf"] = bool(torch.equal(loss1, loss2)) and all(
            torch.equal(a, b) for a, b in zip(field_leaves(p1),
                                              field_leaves(p2)))

        # one mesh-fit chunk of SHARD_FIT_STEPS, sharded and not
        m.lpips_params = runner.load_lpips()
        rposes, rintr, rlights = _rig(SIZE)
        init = runner.load_init_mesh(torus_knot(), rposes, rintr, SIZE,
                                     rlights)
        targets = {"images": init["images"], "masks": init["masks"],
                   "poses": torch.as_tensor(rposes, device=DEV),
                   "intrinsics": torch.as_tensor(rintr, device=DEV),
                   "cam_weights": torch.ones(REQ_VIEWS, device=DEV),
                   "cam_lights": torch.as_tensor(rlights, device=DEV)}
        fits = []
        for dm in (mesh, None):
            m.device_mesh = dm
            pipe = MVEdit3DPipeline(m, cfg)
            tet_grid, state, opt = pipe._init_mesh_phase(fresh(), device=DEV)
            run, _, _ = pipe._mesh_fit_fns(tet_grid, SHARD_FIT_STEPS)
            g2 = torch.Generator(device=DEV).manual_seed(SEED + 26)
            fits.append(sync_time(
                "mesh_fit_" + ("sharded" if dm else "plain"),
                lambda: run(state, opt, targets,
                            sched=pipe._sched_weights(0.65, "mesh"),
                            generator=g2, lpips_params=m.lpips_params)))
        m.device_mesh = None
        (s1, _, o1), (s2, _, o2) = fits
        same["mesh_fit"] = bool(torch.equal(o1["loss"], o2["loss"])) and \
            bool(torch.equal(s1["sdf"], s2["sdf"])) and \
            bool(torch.equal(s1["deform"], s2["deform"]))
        del fits, s1, s2, o1, o2

        # phase 7's first request, sharded
        first = req_ctx["first"]
        runner.device_mesh = mesh
        with tempfile.TemporaryDirectory() as tmp:
            # phase 7's input, written again (its directory is gone)
            from mvedit_tpu_torch.models.mesh import Mesh
            knot, src_glb = torus_knot(), os.path.join(tmp, "knot.glb")
            Mesh(v=knot.v, f=knot.f).write_glb(src_glb)
            dst = os.path.join(tmp, "sharded.glb")
            out = sync_time("request_sharded", lambda: runner.run_3d_to_3d(
                src_glb, "a golden torus knot, studio light",
                seed=SEED, steps=REQ_STEPS, num_views=REQ_VIEWS,
                init_inverse_steps=REQ_INIT_INV, n_inverse_steps=REQ_N_INV,
                tet_init_inverse_steps=REQ_TET_INIT, out_path=dst))
            with open(dst, "rb") as f:
                glb = f.read()
        same["request_views"] = bool(torch.equal(out["renders"]["rgb"],
                                                 first["rgb"]))
        same["request_glb"] = glb == first["glb"]
    finally:
        runner.device_mesh = None
        dist.destroy_process_group()
    n = dict(flash=flash_attention.launches - fa0,
             segment=SS.segment_sum.launches - seg0)
    ok = all(same.values()) and n["flash"] > 0 and n["segment"] > 0
    log(f"[sharded] world size 1 over NCCL: the CFG step on 2 x {N} views "
        f"of {SIZE}^2 (SD1.5), the NeRF step on phase 7's field (128^2 "
        f"rays), a {SHARD_FIT_STEPS}-step mesh-fit chunk, and phase 7's "
        f"request with device_mesh set; bit-equal to unsharded {same}; "
        f"wall (s) " + ", ".join(f"{k} " + " / ".join(
            f"{x:.4f}" for x in v) for k, v in times.items())
        + f"; phase 7's requests (cold / warm) "
        + " / ".join(f"{x:.3f}" for x in first["walls"]) + " s "
        f"{'ok' if ok else 'FAIL'}")
    log(f"[launches] sharded: flash_attention {n['flash']}, segment_sum "
        f"{n['segment']}")
    if not ok:
        raise AssertionError("the sharded phase failed its checks")
    return n


def _viewer_overflow(viewer, azis):
    """Per turntable frame, the tiles whose pair list overflows the
    viewer's raster capacity and the big triangles beyond its big list:
    (overflowing tiles summed over the frames, the most in one frame,
    pairs dropped, big triangles dropped)."""
    import importlib
    from mvedit_tpu_torch.models.mesh import pose_to_w2c
    from mvedit_tpu_torch.utils.camera import get_pose_from_angles
    RZ = importlib.import_module("mvedit_tpu_torch.models.mesh.rasterize")
    cfg, dev = viewer.raster_cfg, viewer.verts.device
    fmask = torch.ones(viewer.faces.shape[0], dtype=torch.bool, device=dev)
    intr = torch.as_tensor(viewer.intrinsics, device=dev)
    tiles, most, pairs_dropped, big_dropped = 0, 0, 0, 0
    for a in azis:
        pose = get_pose_from_angles(np.asarray([a], np.float32),
                                    np.asarray([viewer.elev], np.float32),
                                    viewer.distance)[0, :3]
        pts = RZ.project_mesh(viewer.verts,
                              pose_to_w2c(torch.as_tensor(pose, device=dev)),
                              intr, cfg.near)
        pairs, big = RZ.tile_load(pts, viewer.faces, fmask, cfg)
        over = int((pairs > cfg.k_per_tile).sum())
        tiles += over
        most = max(most, over)
        pairs_dropped += int((pairs - cfg.k_per_tile).clamp(min=0).sum())
        big_dropped += max(0, big - cfg.k_big)
    return tiles, most, pairs_dropped, big_dropped


def phase_viewer(tmp):
    """Phase 26 (a): `MeshViewer` at its defaults (512^2, the default raster
    capacities) on phase 7's warm GLB, or on the first of VIEWER_KNOTS
    that overflows no tile where that one does; a VIEWER_FRAMES turntable
    written to a file. Returns the raster launches."""
    from mvedit_tpu_torch.apis.viewer import MeshViewer
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh import Mesh
    azis = np.linspace(0, 2 * np.pi, VIEWER_FRAMES, endpoint=False)
    glb = Mesh.load(os.path.join(tmp, "out_warm.glb"))
    viewer = MeshViewer(glb, render_size=VIEWER_SIZE, device=DEV)
    over = _viewer_overflow(viewer, azis)
    log(f"[viewer] phase 7's GLB: {len(glb.f)} faces, uvs "
        f"{glb.vt is not None and len(glb.vt) == len(glb.v)}; at "
        f"{VIEWER_SIZE}^2 with K {viewer.raster_cfg.k_per_tile} + "
        f"{viewer.raster_cfg.k_big}: {over[0]} overflowing tiles over "
        f"{VIEWER_FRAMES} frames ({over[2]} pairs and {over[3]} big "
        f"triangles dropped)")
    what = "phase 7's GLB"
    # the knot, ever coarser, until no frame overflows
    for nu, nv in VIEWER_KNOTS:
        if not (over[0] or over[3]):
            break
        knot = torus_knot(nu=nu, nv=nv)
        mesh = Mesh(v=knot.v, f=knot.f)
        mesh.auto_normal()
        viewer = MeshViewer(mesh, render_size=VIEWER_SIZE, device=DEV)
        over = _viewer_overflow(viewer, azis)
        what = f"the {len(knot.f)}-face knot"
        log(f"[viewer] {what}: {over[0]} overflowing tiles over the frames "
            f"({over[2]} pairs and {over[3]} big triangles dropped)")
    if over[0] or over[3]:
        raise AssertionError("the viewed mesh overflows the viewer's tiles")
    render, frames, frames_ms = viewer.render_fn, [], []

    def timed(pose, intr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(pose, intr)        # a host array: the frame is done
        frames_ms.append((time.perf_counter() - t0) * 1e3)
        frames.append(img)
        return img
    viewer.render_fn = timed
    RS.raster_select.launches = 0
    staged = RS.raster_select.staged
    t0 = time.perf_counter()
    path = viewer.render_turntable(VIEWER_FRAMES,
                                   os.path.join(tmp, "viewer.mp4"))
    wall = time.perf_counter() - t0
    launches = RS.raster_select.launches
    frames = np.stack(frames)
    cover = float((frames < 1).any(-1).mean())
    ok = (launches == len(frames) == VIEWER_FRAMES
          and os.path.getsize(path) > 0 and np.isfinite(frames).all()
          and cover > 0.01 and RS.raster_select.staged == staged)
    log(f"[viewer] MeshViewer on {what}, {VIEWER_FRAMES}-frame turntable "
        f"to {os.path.basename(path)} ({os.path.getsize(path)} bytes) in "
        f"{wall:.3f} s: {statistics.median(frames_ms):.3f} ms a frame "
        f"(median; first {frames_ms[0]:.3f}), raster_select {launches} "
        f"launches, covered share {cover:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the mesh viewer failed its checks")
    return launches


def phase_ssdnerf_viewer(runner, tmp):
    """Phase 26 (b): `SSDNeRFViewer` around phase 17's sample (the port's
    code sample and triplane decoder at the preview's camera): generate,
    `export_vdb` at EXPORT_RES and `export_mesh` at EXPORT_MESH_RES, a
    screenshot, a 6-view
    grid and a short video."""
    from mvedit_tpu_torch.apis import cameras as C
    from mvedit_tpu_torch.apis.viewer import SSDNeRFViewer
    from mvedit_tpu_torch.models.nerf_fit import make_image_renderer
    from mvedit_tpu_torch.models.ssdnerf import tanh_code
    from mvedit_tpu_torch.utils import camera as cam_utils
    c = C.CONSTANTS
    size = 160
    scene = {}

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=DEV)

    def sample_fn(prompt, negative_prompt, seed, steps, cfg_scale):
        out = runner.run_stablessdnerf(prompt, seed=seed, steps=steps)
        cfg = out["ssdnerf_cfg"]
        scene["cfg"] = cfg
        scene["params"] = {"decoder": out["decoder"],
                           "code": tanh_code(out["code"])}
        scene["decode"] = decode = runner._triplane_decode(cfg)
        render = make_image_renderer(decode, size, size, cfg.render,
                                     chunk=size * size, use_grid=False)

        def render_fn(pose, intr):
            with torch.no_grad():
                img = render(scene["params"], f32(pose), f32(intr))
            return img["rgb"].float().clamp(0, 1).cpu().numpy()
        return out["code"], render_fn

    def density_fn(xyz):
        return scene["decode"](scene["params"], xyz)[0]

    viewer = SSDNeRFViewer(
        sample_fn, cam_utils.intrinsics_from_fov(c["ssdnerf_fov"], size,
                                                 size),
        density_fn=density_fn, distance=c["ssdnerf_camera_distance"],
        elev=0.3, device=DEV)
    t0 = time.perf_counter()
    code = viewer.generate(T23_PROMPT, seed=SEED, steps=T23_STEPS)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sigma = viewer.export_vdb(os.path.join(tmp, "t23.vdb"),
                              resolution=EXPORT_RES)
    t_vdb = time.perf_counter() - t0
    vdb_bytes = os.path.getsize(os.path.join(tmp, "t23.vdb"))
    active = int((sigma > 0.01).sum())
    lo, hi = float(sigma.min()), float(sigma.max())
    thr = 0.5 * (lo + hi)
    t0 = time.perf_counter()
    mesh = viewer.export_mesh(os.path.join(tmp, "t23_export.glb"),
                              resolution=EXPORT_MESH_RES, threshold=thr)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    shot = viewer.export_screenshot(os.path.join(tmp, "t23_shot.png"))
    grid = viewer.export_multi_view(os.path.join(tmp, "t23_mv_{}.png"), 6)
    video = viewer.export_video(os.path.join(tmp, "t23_turn.mp4"),
                                num_frames=EXPORT_VIDEO_FRAMES)
    t_img = time.perf_counter() - t0
    ok = (tuple(code.shape) == tuple(scene["cfg"].latent_shape)
          and sigma.shape == (EXPORT_RES,) * 3 and np.isfinite(sigma).all()
          and vdb_bytes > 0 and len(mesh.f) > 0
          and shot.shape == (size, size, 3) and grid.shape[0] == 6
          and np.isfinite(grid).all() and os.path.getsize(video) > 0)
    log(f"[ssdnerf_viewer] generate ({T23_STEPS} steps) {t_gen:.3f} s; "
        f"export_vdb at {EXPORT_RES}^3: {sigma.size} densities on the card,"
        f" {active} active voxels (> 0.01), {vdb_bytes} bytes, "
        f"{t_vdb:.3f} s; density range [{lo:.4f}, {hi:.4f}] (the "
        f"reference's export threshold 10 "
        f"{'is' if lo < 10 < hi else 'is not'} inside it); export_mesh at "
        f"{EXPORT_MESH_RES}, threshold {thr:.4f}: "
        f"{len(mesh.f)} faces in {t_mesh:.3f} s; "
        f"screenshot, 6-view grid and a {EXPORT_VIDEO_FRAMES}-frame video "
        f"({os.path.basename(video)}) in {t_img:.3f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the SSDNeRF viewer failed its checks")


def phase_debug_request(runner, tmp, req_ctx):
    """Phase 26 (c): phase 7's request with `debug=1`, cut in depth to
    DEBUG_STEPS diffusion steps (and DEBUG_N_INV / DEBUG_TET_INIT fit
    steps) to keep the smoke under its time limit, so its GLB is not held
    to phase 7's (the tiny CPU parity request holds a GLB with and
    without the tiles to equal bytes): one tile PNG a view a step, the
    time inside `save_tiled_viz` as the tiles' added wall. Returns the
    flash, raster and segment-sum launches."""
    import mvedit_tpu_torch.models.diffusion.attention as TA
    import mvedit_tpu_torch.utils.debug_viz as DV
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import flash_attention
    from mvedit_tpu_torch.models.mesh import Mesh
    from mvedit_tpu_torch.utils import profiling as PR
    out_dir = os.path.join(tmp, "debug_tiles")
    build, save, tiles_s = runner._cfg_from_schema, DV.save_tiled_viz, []

    def with_debug(*a, **k):
        return dataclasses.replace(build(*a, **k), debug=1,
                                   debug_dir=out_dir)

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        save(*a, **k)
        tiles_s.append(time.perf_counter() - t0)
    runner._cfg_from_schema = with_debug
    DV.save_tiled_viz = timed_save
    shapes = {}
    kernel, recording = _record_shapes(TA, shapes)
    TA.flash_attention = recording
    flash_attention.launches = RS.raster_select.launches = 0
    SS.segment_sum.launches = 0
    pt = PR.PhaseTimer()
    PR.set_phase_timer(pt)
    dst = os.path.join(tmp, "out_debug.glb")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        runner.run_3d_to_3d(
            req_ctx["src"], "a golden torus knot, studio light", seed=SEED,
            steps=DEBUG_STEPS, num_views=REQ_VIEWS,
            init_inverse_steps=REQ_INIT_INV, n_inverse_steps=DEBUG_N_INV,
            tet_init_inverse_steps=DEBUG_TET_INIT, out_path=dst)
        torch.cuda.synchronize()
    finally:
        del runner._cfg_from_schema
        DV.save_tiled_viz = save
        TA.flash_attention = kernel
        PR.set_phase_timer(None)
    wall = time.perf_counter() - t0
    n = dict(flash=flash_attention.launches,
             raster=RS.raster_select.launches,
             segment=SS.segment_sum.launches)
    back = Mesh.load(dst)
    views = sum(sig[2] for sig in pt.sigs["render_all"])
    pngs = sorted(os.listdir(out_dir))
    ok = (len(back.f) > 0 and back.albedo is not None
          and np.isfinite(back.albedo).all() and len(pngs) == views > 0
          and len(tiles_s) == pt.counts["render_all"]
          and min(n.values()) > 0)
    log(f"[debug] phase 7's request with debug=1, cut to {DEBUG_STEPS} "
        f"steps (n_inverse_steps {DEBUG_N_INV}, tet_init_inverse_steps "
        f"{DEBUG_TET_INIT}; phase 7: {REQ_STEPS}, {REQ_N_INV}, "
        f"{REQ_TET_INIT}): {wall:.3f} s wall, {sum(tiles_s):.3f} s of it "
        f"writing {len(pngs)} tiles for {views} views over "
        f"{pt.counts['render_all']} steps; GLB {len(back.f)} faces; "
        f"flash_attention {n['flash']}, raster_select {n['raster']}, "
        f"segment_sum {n['segment']} launches {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the debug request failed its checks")
    check_shapes("debug", shapes)
    return n


def phase_webui_adapters(runner, tmp, knot_glb, image, video_glb):
    """Phase 26 (d): three of the web UI's endpoint adapters on the card,
    each with its positional contract (`endpoint_signature`). Returns the
    raster launches."""
    from mvedit_tpu_torch.apis import webui
    from mvedit_tpu_torch.kernels import raster_select as RS
    fns = webui.endpoint_adapters(runner)
    values = {"mesh": knot_glb, "image": image, "front_view_id": 0,
              "distance": 4.0, "elevation": 10.0, "fov": 30, "length": 2,
              "resolution": 256, "lossless": False, "layer": "RGB"}
    RS.raster_select.launches = 0
    res, secs = {}, {}
    for name, over in (("3d_preproc", {}), ("image_segmentation", {}),
                       ("mesh_to_video", {"mesh": video_glb})):
        args = [dict(values, **over)[k]
                for k in webui.endpoint_signature(name)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = fns[name](*args)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    path, state, fvid = res["3d_preproc"]
    rgba = res["image_segmentation"]
    video = res["mesh_to_video"]
    launches = RS.raster_select.launches
    ok = (os.path.getsize(path) > 0 and json.loads(state)["scale"] > 0
          and fvid == 0 and rgba.dtype == np.uint8
          and rgba.shape == image.shape[:2] + (4,)
          and np.abs(rgba[..., :3].astype(np.int32)
                     - image[..., :3]).max() <= 1
          and os.path.getsize(video) > 0 and launches > 0)
    log(f"[webui] adapters on the card: 3d_preproc {secs['3d_preproc']:.3f}"
        f" s (scale {json.loads(state)['scale']:.4f}); image_segmentation "
        f"{secs['image_segmentation']:.3f} s ({rgba.shape} RGBA, "
        f"{float((rgba[..., 3] > 127).mean()):.4f} foreground); "
        f"mesh_to_video {secs['mesh_to_video']:.3f} s "
        f"({os.path.basename(video)}); raster_select {launches} launches "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the web UI adapters failed their checks")
    return launches


def phase_tools(tmp, ckpt):
    """Phase 26 (e): `convert_weights --all` over phase 9's SRVGG and tile
    ControlNet under MANIFEST names (a runner of its output must give
    phase 9's outputs), `generate_tets` at TETS_TOOL_RES with an empty
    cache, and the endpoint walkthrough at `--tiny` on the card."""
    import shutil
    import tempfile
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from mvedit_tpu_torch.tools import (convert_weights, example_api_local,
                                        generate_tets)
    zoo, out = os.path.join(tmp, "zoo"), os.path.join(tmp, "zoo_out")
    for name, src in (
            ("control_v11f1e_sd15_tile", os.path.join(
                tmp, "checkpoint_safetensors", "controlnet_tile",
                "controlnet_tile.safetensors")),
            ("realesr-general-x4v3", os.path.join(
                tmp, "checkpoint_bin", "image_enhancer",
                "pytorch_model.bin"))):
        os.makedirs(os.path.join(zoo, name))
        fname = "diffusion_pytorch_model.safetensors" \
            if src.endswith(".safetensors") else "pytorch_model.bin"
        shutil.copyfile(src, os.path.join(zoo, name, fname))
    t0 = time.perf_counter()
    report = convert_weights.main(["--all", "--src", zoo, "--out-dir", out])
    t_conv = time.perf_counter() - t0
    dst = Adapter3DRunner(checkpoint_dir=out, seed=SEED + 400, device=DEV)
    got = ckpt["outputs"](dst.load_image_enhancer(),
                          dst.load_controlnets(("tile",))[0])
    equal = all(bool(torch.equal(a, b)) for a, b in zip(got, ckpt["ref"]))
    laid = [k for k, v in report.items() if v.startswith("ok")]
    ok = equal and sorted(laid) == ["control_v11f1e_sd15_tile",
                                    "realesr-general-x4v3"] and all(
        "(0 unmatched, 0 missing)" in report[k] for k in laid)
    log(f"[tools] convert_weights --all: {len(laid)} entries laid out in "
        f"{t_conv:.3f} s ({'; '.join(report[k] for k in laid)}), "
        f"{sum(v == 'missing' for v in report.values())} missing; a runner "
        f"of the output gives phase 9's outputs: {equal} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the convert_weights round trip failed")
    del dst, got
    torch.cuda.empty_cache()
    cache = os.environ.get("MVEDIT_TORCH_TET_CACHE")
    with tempfile.TemporaryDirectory() as empty:
        os.environ["MVEDIT_TORCH_TET_CACHE"] = empty
        try:
            t0 = time.perf_counter()
            path = generate_tets.main(["--resolution", str(TETS_TOOL_RES),
                                       "--out", os.path.join(
                                           tmp, "tets", "tets.npz")])
            t_tets = time.perf_counter() - t0
        finally:
            if cache is None:
                del os.environ["MVEDIT_TORCH_TET_CACHE"]
            else:
                os.environ["MVEDIT_TORCH_TET_CACHE"] = cache
    with np.load(path) as d:
        nv, nt = len(d["vertices"]), len(d["indices"])
    ok = nt > 0 and nv > 0
    log(f"[tools] generate_tets --resolution {TETS_TOOL_RES}: {nv} verts, "
        f"{nt} tets in {t_tets:.3f} s (cold) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("generate_tets wrote no grid")
    # the tiny models' f32 attention inputs are staged for the flash
    # kernel by design: the walkthrough's staged copies stay out of the
    # paths' counts, which must be 0
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import launch
    staged = (launch.staged, RS.raster_select.staged, SS.segment_sum.staged)
    t0 = time.perf_counter()
    try:
        walk = example_api_local.main([
            "--tiny", "--device", DEV, "--out-dir",
            os.path.join(tmp, "walkthrough")])
    finally:
        walk_staged = (launch.staged - staged[0],
                       RS.raster_select.staged - staged[1],
                       SS.segment_sum.staged - staged[2])
        launch.staged, RS.raster_select.staged, SS.segment_sum.staged = \
            staged
    t_walk = time.perf_counter() - t0
    ok = (walk["3d_to_3d"] and walk["zero123plus_to_mesh"]
          and os.path.exists(walk["video"]))
    log(f"[tools] example_api_local --tiny on the card: {len(walk)} "
        f"endpoints in {t_walk:.3f} s; staged copies of the tiny models' "
        f"inputs (flash, raster, segment sum): {walk_staged} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the walkthrough failed its checks")


def phase_cleaner(tmp):
    """Phase 26 (e), after phase 22: `checkpoint_cleaner --save-inf --yes`
    on phase 19's first training work dir: one step left, without
    optimiser states, its floats in float16."""
    from mvedit_tpu_torch.runner.trainer import CheckpointHook
    from mvedit_tpu_torch.tools import checkpoint_cleaner
    work = os.path.join(tmp, "train_first")
    before = sorted(d for d in os.listdir(work) if d.startswith("step_"))
    checkpoint_cleaner.main([work, "--save-inf", "--yes"])
    after = sorted(d for d in os.listdir(work) if d.startswith("step_"))
    state, step = CheckpointHook.load(work)
    floats = [x.dtype for x in _leaves(state) if torch.is_tensor(x)
              and x.is_floating_point()]
    ok = (len(before) > 1 and after == [f"step_{step}"]
          and not any(k.endswith("_opt") for k in state)
          and "decoder" in state and floats
          and set(floats) == {torch.float16})
    log(f"[tools] checkpoint_cleaner --save-inf on phase 19's work dir: "
        f"{before} -> {after}, kept keys {sorted(state)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("checkpoint_cleaner failed its checks")


_FAMILIES = [
    ("flash kernel", r"flash_fwd_kernel"),
    ("raster select kernel", r"raster_select_kernel"),
    ("sort / scan", r"radix|Sort|scan|cub::"),
    ("index / scatter", r"index|scatter|gather"),
    ("layout transpose", r"nchwToNhwc|nhwcToNchw"),
    ("convolution", r"fprop|dgrad|conv"),
    ("matmul", r"gemm|nvjet|cutlass"),
    ("normalization", r"Moments|GroupNorm|layer_norm"),
    ("softmax", r"softmax"),
    ("copy / cast", r"copy|memcpy|memset"),
    ("elementwise", r"elementwise|upsample"),
]


def _union(intervals):
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def read_trace(path, window):
    """Kernel-by-kernel reading of a profiler chrome trace: the host wall
    of the `window` ranges, the device's busy time inside them (the union
    of kernel, memcpy and memset intervals), the device time of the
    kernels launched from inside each other named range, by kernel family,
    and the top kernels. Times in ms."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    wins, ranges = [], {}
    for e in ev:
        if e.get("cat") == "user_annotation":
            iv = (e["ts"], e["ts"] + e["dur"])
            if e["name"] == window:
                wins.append(iv)
            elif not e["name"].startswith("ProfilerStep"):
                ranges.setdefault(e["name"], []).append(iv)
    launched = {e["args"]["correlation"]: e["ts"] for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                            "gpu_memset")
           and any(a <= e["ts"] < b for a, b in wins)]
    busy = _union([(e["ts"], min(e["ts"] + e["dur"], b)) for e in dev
                   for a, b in wins if a <= e["ts"] < b])
    wall = sum(b - a for a, b in wins)
    per_range = {n: dict(wall_ms=sum(b - a for a, b in ivs) / 1e3,
                         device_ms=0.0, calls=len(ivs))
                 for n, ivs in ranges.items()}
    families, names = {}, {}
    for e in dev:
        t = launched.get(e.get("args", {}).get("correlation"))
        for n, ivs in ranges.items():
            if t is not None and any(a <= t <= b for a, b in ivs):
                per_range[n]["device_ms"] += e["dur"] / 1e3
        fam = next((f for f, pat in _FAMILIES
                    if re.search(pat, e["name"], re.I)), "other")
        families[fam] = families.get(fam, 0.0) + e["dur"] / 1e3
        c, ms = names.get(e["name"], (0, 0.0))
        names[e["name"]] = (c + 1, ms + e["dur"] / 1e3)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(window=window, windows=len(wins), wall_ms=wall / 1e3,
                device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / wall if wall else None,
                device_events=len(dev), ranges=per_range,
                families=dict(sorted(families.items(), key=lambda kv: -kv[1])),
                top=[dict(name=n, count=c, ms=ms) for n, (c, ms) in top])


def _report(out_dir, label, window):
    path = os.path.join(out_dir, f"{label}.trace.json")
    r = read_trace(path, window)
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        g.write(f.read())
    os.remove(path)
    with open(os.path.join(out_dir, f"{label}_summary.json"), "w") as f:
        json.dump(r, f, indent=1)
    log(f"[profile] {label}: {r['windows']} x {window!r}, host wall "
        f"{r['wall_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, "
        f"idle share {r['idle_share']:.4f}, {r['device_events']} device "
        f"events")
    for n, d in r["ranges"].items():
        log(f"[profile] {label}   range {n} x{d['calls']}: host wall "
            f"{d['wall_ms']:.3f} ms, device {d['device_ms']:.3f} ms")
    for fam, ms in r["families"].items():
        log(f"[profile] {label}   family {fam}: {ms:.3f} ms")
    for t in r["top"]:
        log(f"[profile] {label}   top {t['ms']:.3f} ms x{t['count']}: "
            f"{t['name'][:100]}")


def phase_profile(runner, out_dir, mesh_ctx):
    """`torch.profiler` over one warm `run_text_to_img` request, two warm
    denoise timesteps (the first of three is the profiler's warm-up), two
    warm 2-step mesh fit chunks and two warm 8-step NeRF fit chunks at
    256^2 (LPIPS on). The profiler's own host cost per op widens the gaps,
    so the idle share under it bounds the unprofiled one from above."""
    from torch.profiler import ProfilerActivity, profile, schedule
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def export(label):
        return lambda p: p.export_chrome_trace(
            os.path.join(out_dir, f"{label}.trace.json"))

    with profile(activities=acts, on_trace_ready=export("text_to_img"),
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for seed in (3, 4):
            with R("request"):
                runner.run_text_to_img("a red car on a hill", seed=seed,
                                       steps=STEPS_T2I)
                torch.cuda.synchronize()
            prof.step()
    _report(out_dir, "text_to_img", "request")
    log("[profile] denoise timesteps under the profiler:")
    with profile(activities=acts, on_trace_ready=export("denoise"),
                 schedule=schedule(wait=0, warmup=1,
                                   active=DENOISE_RUN - 1,
                                   repeat=1)) as prof:
        phase_denoise(runner, prof)
    _report(out_dir, "denoise", "timestep")
    log("[profile] mesh fit chunks (2 steps each) under the profiler:")
    c = mesh_ctx
    run, _, _ = c["pipe"]._mesh_fit_fns(c["tet_grid"], 2)
    with profile(activities=acts, on_trace_ready=export("mesh_fit"),
                 schedule=schedule(wait=0, warmup=1, active=2,
                                   repeat=1)) as prof:
        for _ in range(3):
            with R("fit_chunk"):
                run(c["state"], c["opt"], c["targets"],
                    sched=c["pipe"]._sched_weights(0.6, "mesh"),
                    generator=c["gen"])
                torch.cuda.synchronize()
            prof.step()
    _report(out_dir, "mesh_fit", "fit_chunk")
    log("[profile] NeRF fit chunks (8 steps each, 256^2) under the "
        "profiler:")
    from mvedit_tpu_torch.models.fields import ingp_init
    from mvedit_tpu_torch.models.volume_renderer import OccupancyGrid
    from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline
    m = runner.load_stable_diffusion()
    m.lpips_params = runner.load_lpips()
    cfg = runner._mvedit_cfg(REQ_VIEWS, REQ_STEPS, REQ_N_INV, REQ_INIT_INV)
    pipe = MVEdit3DPipeline(m, cfg)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    field = ingp_init(cfg.ingp, gen, DEV)
    run, make_opt = pipe._nerf_fit_fns(256, 8)
    opt = make_opt(field)
    grid = OccupancyGrid.create(cfg.render.grid_size, device=DEV)
    tgt = pipe._resize_targets(c["targets"], 256)
    with profile(activities=acts, on_trace_ready=export("nerf_fit"),
                 schedule=schedule(wait=0, warmup=1, active=2,
                                   repeat=1)) as prof:
        for _ in range(3):
            with R("nerf_chunk"):
                field, opt, grid, out = run(
                    field, opt, grid, tgt,
                    sched=pipe._sched_weights(0.5, "nerf"),
                    lpips_params=m.lpips_params, generator=gen)
                torch.cuda.synchronize()
            prof.step()
    _report(out_dir, "nerf_fit", "nerf_chunk")
    log("[profile] render-all of 16 views at 256^2 (NeRF branch) and the "
        "SRVGG enhancer to 512^2 under the profiler:")
    views = {"poses": c["targets"]["poses"][:16],
             "intrinsics": c["targets"]["intrinsics"][:16]}
    enhance = runner.load_image_enhancer()
    with profile(activities=acts, on_trace_ready=export("render_all"),
                 schedule=schedule(wait=0, warmup=1, active=2,
                                   repeat=1)) as prof:
        for _ in range(3):
            with R("render_all"):
                with R("nerf_render"):
                    r = pipe._render_all(field, None, None, grid, views, 256)
                with R("srvgg"):
                    enhance(r["rgb"], 512)
                torch.cuda.synchronize()
            prof.step()
    _report(out_dir, "render_all", "render_all")


def phase_time_fits(runs=5):
    """Host-clock medians (after `torch.cuda.synchronize()`) of a warm
    NeRF-fit chunk (8 steps at 256^2, LPIPS on, the request's field and
    schedule), of a NeRF render-all of 16 views at 256^2, and of a warm
    mesh-fit chunk (8 steps at the request's tet resolution and 512^2,
    LPIPS on), on the 32-view `load_init_mesh` renders of the torus knot.
    Only APIs that every tree of the port with `run_3d_to_3d` has are
    used, so that a copy of this script beside an earlier checkout's
    package times that one in the same call."""
    import types
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from mvedit_tpu_torch.models.fields import ingp_init
    from mvedit_tpu_torch.models.volume_renderer import OccupancyGrid
    from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline
    import mvedit_tpu_torch
    runner = Adapter3DRunner(seed=SEED, device=DEV)
    m = types.SimpleNamespace(lpips_params=runner.load_lpips())
    cfg = runner._mvedit_cfg(REQ_VIEWS, REQ_STEPS, REQ_N_INV, REQ_INIT_INV)
    pipe = MVEdit3DPipeline(m, cfg)
    poses, intr, lights = _rig(SIZE)
    init = runner.load_init_mesh(torus_knot(), poses, intr, SIZE, lights)
    targets = {"images": init["images"], "masks": init["masks"],
               "poses": torch.as_tensor(poses, device=DEV),
               "intrinsics": torch.as_tensor(intr, device=DEV),
               "cam_lights": torch.as_tensor(lights, device=DEV),
               "cam_weights": torch.ones(REQ_VIEWS, device=DEV)}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    field = ingp_init(cfg.ingp, gen, DEV)
    run, make_opt = pipe._nerf_fit_fns(256, 8)
    opt = make_opt(field)
    grid = OccupancyGrid.create(cfg.render.grid_size, device=DEV)
    tgt = pipe._resize_targets(targets, 256)
    views = {"poses": targets["poses"][:16],
             "intrinsics": targets["intrinsics"][:16]}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    chunk = []
    for i in range(runs + 1):
        (field, opt, grid, _), sec = timed(lambda: run(
            field, opt, grid, tgt, sched=pipe._sched_weights(0.5, "nerf"),
            lpips_params=m.lpips_params, generator=gen))
        if i:
            chunk.append(sec)
    render = []
    with torch.no_grad():
        for i in range(4):
            _, sec = timed(lambda: pipe._render_all(field, None, None, grid,
                                                    views, 256))
            if i:
                render.append(sec)
    # the DMTet fit at tet 128 from a seeded field (phase 6's stand-in)
    mfield = ingp_init(cfg.ingp, gen, DEV)
    with torch.no_grad():
        mfield["mlp"][-1]["b"][0] = DENSITY_BIAS
    tet_grid, state, mopt = pipe._init_mesh_phase(mfield, device=DEV)
    run_m, _, _ = pipe._mesh_fit_fns(tet_grid, 8)
    mesh = []
    for i in range(runs + 1):
        (state, mopt, _), sec = timed(lambda: run_m(
            state, mopt, targets, sched=pipe._sched_weights(0.6, "mesh"),
            generator=gen, lpips_params=m.lpips_params))
        if i:
            mesh.append(sec)

    def fmt(xs):
        return (f"median {statistics.median(xs):.4f} s of {len(xs)} "
                f"({' '.join(f'{x:.4f}' for x in xs)})")
    log(f"[fits] package {os.path.dirname(mvedit_tpu_torch.__file__)}: "
        f"NeRF-fit chunk (8 steps, 256^2, LPIPS) {fmt(chunk)}; render-all "
        f"of 16 views at 256^2 {fmt(render)}; mesh-fit chunk (8 steps, "
        f"tet {cfg.tet_resolution}, 512^2, LPIPS) {fmt(mesh)}")


def phase_time_retex():
    """Three `run_retex` requests of one seed at the defaults (phase 10's
    inputs) on the `mvedit_tpu_torch` beside the script: a cold and a warm
    one timed on the host clock, then one under `torch.profiler` (CUDA
    activity only) with every segment sum run on a stream of its own, so
    that the kernels on that stream are the sums' (their ordering, sorts
    and offsets included, in whatever form the tree has them): their
    device time summed from the trace, beside the stream's span per call
    from CUDA events (which also counts waits for the host's launches).
    Only APIs that every tree of the port with `run_retex` has are used,
    so that a copy of this script beside an earlier checkout's package
    times that one in the same call."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    import mvedit_tpu_torch
    import mvedit_tpu_torch.ops.segment as OS
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from mvedit_tpu_torch.models.mesh import Mesh
    runner = Adapter3DRunner(seed=SEED, device=DEV)
    tmp = tempfile.mkdtemp()
    src = os.path.join(tmp, "retex_knot.glb")
    knot = torus_knot()
    Mesh(v=knot.v, f=knot.f).write_glb(src)
    img = np.random.default_rng(SEED + 13).random(
        (SIZE, SIZE, 3)).astype(np.float32)

    def request():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.run_retex(
            src, "a golden torus knot, studio light", seed=SEED,
            steps=RETEX_STEPS, n_inverse_steps=RETEX_N_INV,
            num_views=RETEX_VIEWS, front_view_id=0, in_image=img,
            out_path=os.path.join(tmp, "retex.glb"))
        torch.cuda.synchronize()
        return out["mesh"].albedo, time.perf_counter() - t0
    albedo, cold = request()
    albedo2, warm = request()
    orig, side, spans = OS.segment_sum, torch.cuda.Stream(), []

    def on_side(*a, **k):
        main = torch.cuda.current_stream()
        side.wait_stream(main)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            e0.record()
            out = orig(*a, **k)
            e1.record()
        main.wait_stream(side)
        spans.append((e0, e1))
        return out
    OS.segment_sum = on_side
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            albedo3, traced_wall = request()
    finally:
        OS.segment_sum = orig
    span_ms = sum(a.elapsed_time(b) for a, b in spans)
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    # the stream that ran the sums' own kernels (`segment_*` in the
    # kernel source's anonymous namespace, in this tree and earlier ones)
    own = "(anonymous namespace)::segment_"
    streams = {e.device_resource_id() for e in evs if own in e.name()}
    mine = [e for e in evs if e.device_resource_id() in streams]
    dev_ms = sum(e.duration_ns() for e in mine) / 1e6
    all_ms = sum(e.duration_ns() for e in evs) / 1e6
    top = {}
    for e in mine:
        k = re.split(r"[<(]", e.name().split("namespace)::", 1)[-1])[0][:60]
        top[k] = top.get(k, 0.0) + e.duration_ns() / 1e6
    log("[retex-time] the sums' stream by kernel (ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in sorted(top.items(),
                                          key=lambda kv: -kv[1])[:8]))
    same = bool(np.array_equal(albedo, albedo2)) and bool(
        np.array_equal(albedo, albedo3))
    log(f"[retex-time] package {os.path.dirname(mvedit_tpu_torch.__file__)}:"
        f" cold {cold:.3f} s, warm {warm:.3f} s; traced request "
        f"({traced_wall:.3f} s under the profiler): {len(spans)} segment "
        f"sums, {dev_ms:.3f} ms device time in {len(mine)} kernels on "
        f"their stream ({len(streams)} stream), of {all_ms:.3f} ms for "
        f"all {len(evs)} device events; the sums' stream span "
        f"{span_ms:.3f} ms; three albedos bit-equal {same}")
    if not same or not mine:
        raise AssertionError("retex timing: albedos differ or no segment "
                             "kernel was traced")
    # the sums' kernels on more than one stream, or the request's other
    # kernels on theirs, would read the whole request as the sums' time
    if len(streams) != 1 or len(mine) == len(evs):
        raise AssertionError(f"retex timing: the sums' kernels ran on "
                             f"{len(streams)} streams, {len(mine)} of "
                             f"{len(evs)} device events on them: not a "
                             f"stream of their own")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3: build the kernels and hold them "
                         "against their plain versions")
    ap.add_argument("--kernel", choices=("flash_attention", "raster_select",
                                         "flash_fwd", "segment_sum"),
                    help="with --kernels-only: check this kernel only")
    ap.add_argument("--ab", nargs="+", metavar="SRC",
                    help="only build these kernel sources (edited copies of "
                         "csrc/flash_attention.cu or csrc/raster_select.cu),"
                         " check them and time them against each other in "
                         "turns")
    ap.add_argument("--profile", metavar="OUT_DIR",
                    help="after the run, profile a warm text-to-image "
                         "request, denoise timesteps, mesh and NeRF fit "
                         "chunks into OUT_DIR")
    ap.add_argument("--time-fits", action="store_true",
                    help="only time a warm NeRF-fit chunk and a render-all "
                         "(host clock, median of several)")
    ap.add_argument("--time-retex", action="store_true",
                    help="only time retex requests and trace one "
                         "request's segment sums (with --time-fits: both)")
    args = ap.parse_args()
    if args.kernel and not args.kernels_only:
        ap.error("--kernel needs --kernels-only")
    t_start = time.perf_counter()
    smi = phase_device()
    phase_tokenizer()
    if args.time_fits or args.time_retex:
        if args.time_fits:
            phase_time_fits()
        if args.time_retex:
            phase_time_retex()
        return
    if args.ab:
        def raster(src):
            with open(src) as f:
                return "mvedit_raster_select" in f.read()
        flash = [src for src in args.ab if not raster(src)]
        if flash:
            phase_ab_flash(flash)
        if len(flash) < len(args.ab):
            phase_ab_raster([src for src in args.ab if raster(src)])
        return
    phase_build()
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.kernels import segment_sum as SS
    from mvedit_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          launch)
    from mvedit_tpu_torch.ops.flash_attention import flash_fwd
    todo = [args.kernel] if args.kernel else [
        "flash_attention", "raster_select", "flash_fwd", "segment_sum"]
    if "flash_attention" in todo:
        rows, worst = phase_kernel()
    if "raster_select" in todo:
        raster_rows = phase_raster_kernel()
    if "flash_fwd" in todo:
        fwd_rows, fwd_worst = phase_flash_fwd()
    if "segment_sum" in todo:
        seg_rows, seg_worst = phase_segment_sum()
    if not args.kernel:
        phase_lpips()
    if args.kernels_only:
        log(f"[kernels-only] {', '.join(todo)}: every kernel agrees with "
            f"its plain version")
        return
    runner = Adapter3DRunner(seed=SEED, device=DEV)
    phase_unet_route(runner)
    # the denoise path: every launch from here to its end is the path's
    flash_attention.launches = flash_fwd.launches = launch.staged = 0
    phase_text_to_img(runner)
    t2i_launches = flash_attention.launches
    phase_denoise(runner)
    launches = flash_attention.launches
    log(f"[launches] flash_attention: {t2i_launches} in run_text_to_img, "
        f"{launches - t2i_launches} in the denoise timesteps")
    if t2i_launches == 0 or launches == t2i_launches:
        raise AssertionError("the main path did not launch flash_attention")
    # the mesh path: counted part by part inside; no staged raster input
    # from here to the end of the paths; the segment sum counted from here
    # to the end of the retex phase
    RS.raster_select.staged = SS.segment_sum.staged = 0
    SS.segment_sum.launches = 0
    seg_launches = 0
    mesh_launches, mesh_ctx = phase_mesh(runner)
    seg_launches += SS.segment_sum.launches
    # the whole request, twice: counted part by part inside
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        SS.segment_sum.launches = 0
        req_launches, req_flash, req_ctx = phase_request(runner, tmp)
        phase_tet256(runner, req_ctx)
        seg_launches += SS.segment_sum.launches
        ckpt = phase_checkpoint(tmp)
        retex = phase_retex(runner, tmp)
        seg_launches += retex["segment"]
        superres = phase_superres(runner, tmp)
        seg_launches += superres["segment"]
        i23 = phase_image_to_3d(runner, tmp)
        seg_launches += i23["segment"]
        v12 = phase_image_to_3d_v12(runner, tmp)
        seg_launches += v12["segment"]
        t23 = phase_text_to_3d(runner, tmp)
        seg_launches += t23["segment"]
        # phase 26, the last slice, on the outputs of phases 7-17
        t26 = time.perf_counter()
        viewer_raster = phase_viewer(tmp)
        phase_ssdnerf_viewer(runner, tmp)
        debug = phase_debug_request(runner, tmp, req_ctx)
        seg_launches += debug["segment"]
        webui_raster = phase_webui_adapters(
            runner, tmp, req_ctx["src"],
            (i23_input(runner) * 255).astype(np.uint8),
            os.path.join(tmp, "superres_first.glb"))
        phase_tools(tmp, ckpt)
        log(f"[phase 26] (a)-(e) took {time.perf_counter() - t26:.3f} s")
    phase_sam(runner)
    phase_zero123(runner)
    unst = phase_tet_unstructured(runner, req_ctx)
    seg_launches += unst["segment"]
    seg_launches += phase_hash_grid(runner)
    with tempfile.TemporaryDirectory() as tmp:
        train = phase_training(runner, tmp)
        seg_launches += train["segment"]
        lora = phase_stablessdnerf(tmp)
        seg_launches += lora["segment"]
        paper = phase_paper_family(tmp)
        seg_launches += paper["segment"]
        modules = phase_modules(tmp)
        phase_cleaner(tmp)
    log("[modules] " + json.dumps(modules))
    grm = phase_grm()
    seg_launches += grm["segment"]
    phase_tsdf(runner, req_ctx)
    sharded = phase_sharded(runner, req_ctx)
    seg_launches += sharded["segment"]
    log(f"[launches] segment_sum: {seg_launches} over the mesh phase, the "
        f"requests, tet 256, the retex, superres, image-to-3D (v1.1 and "
        f"v1.2) and text-to-3D requests, the unstructured tet grid, the "
        f"hash grid, the two stage-2 training runs ({train['segment']} "
        f"in {train['steps']} steps), the LoRA recipe's runs "
        f"({lora['segment']} in {lora['steps']} steps) and the paper "
        f"family's ({paper['segment']}), GRM's gaussian fits "
        f"({grm['segment']}), the sharded phase ({sharded['segment']}) "
        f"and phase 26's debug request ({debug['segment']}); "
        f"staged copies "
        f"{SS.segment_sum.staged})")
    if seg_launches == 0 or SS.segment_sum.staged:
        raise AssertionError("the paths did not launch segment_sum, or "
                             "staged its inputs")
    # the JAX package's own flash API is on no path of the system (nothing
    # outside its file calls it there): its count over both paths is 0
    fwd_launches = flash_fwd.launches
    log(f"[launches] flash_fwd: {fwd_launches} over both paths (on no path)")
    # every attention input on the paths is aligned bf16 (B, L, H, D) that
    # the kernel's tensor maps read as it is: no staged copy
    log(f"[launches] flash_attention staged copies over the paths: "
        f"{launch.staged}")
    if launch.staged:
        raise AssertionError("the wrapper staged path inputs for the kernel")
    # the rasterizer hands the selection float32 pts, int64 faces and ids,
    # bool masks, contiguous: read as they are
    log(f"[launches] raster_select staged copies over the mesh phase, the "
        f"requests, tet 256, retex, superres, image-to-3D (v1.1 and v1.2), "
        f"text-to-3D, the unstructured tet grid and phase 26: "
        f"{RS.raster_select.staged}; tile 32: {superres['tile32']} "
        f"launches, all in phase 11")
    if RS.raster_select.staged:
        raise AssertionError("the raster wrapper staged path inputs")
    if args.profile:
        phase_profile(runner, args.profile, mesh_ctx)
    log(f"[time] the whole run so far: {time.perf_counter() - t_start:.1f} s")
    hot = next(r for r in rows if r["shape"] == HOT_SHAPE)
    z123 = [dict({k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
                 shape=list(case_dims(r["shape"])[0]),
                 lk=case_dims(r["shape"])[1],
                 launches=i23["by_shape"][str(r["shape"])]
                 + v12["by_shape"][str(r["shape"])])
            for r in rows if r["shape"] in Z123_CASES]
    rhot = next(r for r in raster_rows if r["case"] == RASTER_HOT)
    fhot = next(r for r in fwd_rows if r["shape"] == FWD_HOT)
    shot = next(r for r in seg_rows if r["case"] == SEGMENT_HOT)
    tgrad = next(r for r in seg_rows if r["case"] == "triplane_grad")
    tlora = next(r for r in seg_rows if r["case"] == "triplane_grad_lora")
    tpaper = next(r for r in seg_rows
                  if r["case"] == "triplane_grad_paper")
    ghot = next(r for r in rows if r["shape"] == GRM_SHAPE)
    gseg = next(r for r in seg_rows if r["case"] == "gaussian_backward")
    log(f"[kernels] times and bounds below at {HOT_SHAPE} "
        f"(flash_attention), the {RASTER_HOT} config (raster_select), "
        f"{FWD_HOT} (flash_fwd), {SEGMENT_HOT} (segment_sum: ms the whole "
        f"call, order_ms the ordering alone, kernel_ms the sum kernels "
        f"alone); library_ms is "
        f"one scaled_dot_product_attention call, one index_add_ for "
        f"segment_sum (none computes raster_select); errors over all "
        f"checked cases (raster_select: max |key| error where both cover, "
        f"the mismatched ids and key bits; ms single launches, batched_ms "
        f"{AB_BATCH} per event pair, graphed_ms {AB_BATCH} in a CUDA graph)")
    log(smi)
    log(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "mvedit_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mvedit_tpu/models/diffusion/attention.py:111",
         "launches": launches + req_flash + retex["flash"]
         + superres["flash"] + i23["flash"] + v12["flash"] + t23["flash"]
         + grm["flash"] + sharded["flash"] + debug["flash"],
         "text_to_3d_launches": t23["flash"],
         "grm": dict({k: ghot[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
                     shape=list(GRM_SHAPE), launches=grm["grm_calls"],
                     encoder_s=grm["encoder"]),
         "max_abs_err": worst,
         "ms": hot["ms"], "plain_ms": hot["plain_ms"],
         "bound_ms": hot["bound_ms"], "bound_by": hot["bound_by"],
         "library_ms": hot["library_ms"], "image_to_3d": z123},
        {"name": "raster_select", "route": "cuda",
         "source": "mvedit_tpu_torch/csrc/raster_select.cu",
         "replaces": "mvedit_tpu/models/mesh/select_pallas.py:150",
         "launches": sum(mesh_launches.values())
         + sum(req_launches.values()) + retex["raster"]
         + superres["raster"] + i23["raster"] + v12["raster"]
         + unst["raster"] + t23["raster"] + viewer_raster
         + debug["raster"] + webui_raster,
         "text_to_3d_launches": t23["raster"],
         "viewer_launches": viewer_raster,
         "tile32_launches": superres["tile32"],
         "max_abs_err": max(r["key_err"] for r in raster_rows),
         "mismatched_ids": sum(r["mismatched"] for r in raster_rows),
         "key_bits_differing": sum(r["key_bits"] for r in raster_rows),
         "ms": rhot["ms"], "batched_ms": rhot["batched_ms"],
         "graphed_ms": rhot["graphed_ms"], "plain_ms": rhot["plain_ms"],
         "bound_ms": rhot["bound_ms"], "bound_by": rhot["bound_by"],
         "library_ms": None},
        {"name": "flash_fwd", "route": "cuda",
         "source": "mvedit_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mvedit_tpu/ops/flash_attention.py:73",
         "launches": fwd_launches, "max_abs_err": fwd_worst,
         "ms": fhot["ms"], "plain_ms": fhot["plain_ms"],
         "bound_ms": fhot["bound_ms"], "bound_by": fhot["bound_by"],
         "library_ms": fhot["library_ms"]},
        {"name": "segment_sum", "route": "cuda",
         "source": "mvedit_tpu_torch/csrc/segment_sum.cu",
         "replaces": "none: a port-only kernel (the fixed-order sum behind "
                     "the gathers' gradients; on the TPU XLA scatter-adds, "
                     "mvedit_tpu/ops/segment.py:29)",
         "launches": seg_launches, "max_abs_err": seg_worst,
         "ms": shot["ms"], "order_ms": shot["order_ms"],
         "kernel_ms": shot["kernel_ms"],
         "plain_ms": shot["plain_ms"], "bound_ms": shot["bound_ms"],
         "bound_by": shot["bound_by"],
         "library_ms": shot["library_ms"],
         "training": dict({k: tgrad[k] for k in (
             "ms", "graphed_ms", "order_ms", "kernel_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
             launches=train["segment"], steps=train["steps"],
             step_ms=train["step_ms"], peak_gib=train["peak_gib"]),
         "training_lora": dict({k: tlora[k] for k in (
             "ms", "graphed_ms", "order_ms", "kernel_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
             launches=lora["segment"], steps=lora["steps"],
             step_ms=lora["step_ms"], loader_ms=lora["loader_ms"],
             peak_gib=lora["peak_gib"], lora_params=lora["lora_params"]),
         "training_paper": dict({k: tpaper[k] for k in (
             "ms", "graphed_ms", "order_ms", "kernel_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
             launches=paper["segment"], runs=paper["runs"]),
         "gaussian_backward": dict({k: gseg[k] for k in (
             "ms", "graphed_ms", "order_ms", "kernel_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
             launches=grm["segment"], render_fwd_s=grm["render_fwd"],
             render_bwd_s=grm["render_bwd"])}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
