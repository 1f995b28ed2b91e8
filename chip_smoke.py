#!/usr/bin/env python3
"""Smoke run of the tpurast_torch paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --sanitize-cases   # the case set alone (see 11)
    python3 chip_smoke.py --multi-device     # phase 8's multi_device alone
    python3 chip_smoke.py --named-scenes     # phase 12 alone
    python3 chip_smoke.py --config-matrix    # phases 1 and 1b alone
    python3 chip_smoke.py --shade-kernels    # phase 1c alone

Builds the CUDA kernels from tpurast_torch/csrc, builds a procedural scene
from the seed (a 256x256-quad floor and 64 UV spheres, 258,048 triangles,
eight generated 1024^2 BC4 textures with full mip chains), and then, at
1920x1080:

  1. runs one frame's real inputs through each render kernel (raster,
     resolve, plan, sample) and through its plain torch version on the
     same device, and holds the two against each other: raster depth and
     face id exact; resolve integer planes exact, float planes within
     rtol 1e-5 / atol 1e-6 outside pixels whose mip level l0 flipped (at
     most 0.1% of covered pixels); plan table and assignment exact;
     sample within 1 LSB after the sRGB u8 encode, and its frame under
     an all-residual plan equal to the one under the real plan (the plan
     decides nothing but the empty-tile skip); the sample kernel's other
     page layout and warp shapes are timed beside the shipped one;
 1b. config_matrix: every tile shape and RendererConfig option the
     reference renders that the card had not run, each through a Renderer
     at 1920x1080 on camera 0 (MATRIX): tiles 8x128, 40x128 (8-row chunks),
     16x256, 64x128 and 32x256 (8,192 px), 112x128 (7 chunks), 16x1024 and
     112x896 (100,352 px) on the orbit scene, 112x1920 and 112x3840 on a
     small orbit scene (MATRIX_SMALL_SCENE: the plain raster evaluates every
     pixel of a pair's tile, and the orbit scene's ~190k pairs do not shrink
     with the frame); max_anisotropy 1, 2, 4 and 8; blend "opaque"; output
     "linear" and "gbuf"; gather on float32 and bfloat16 atlas rows;
     binning "scan" at 64x128; deferred at 64x128, equal to gather at 64x128
     bit for bit. Each renders as a graph frame (its median ms over 5
     replays, one launch per kernel of its path a replay) and eagerly inside
     plain_kernels(): color within 1 LSB (linear after the encode; a
     G-buffer under phase 1's resolve rule, face ids exact), depth and the
     counters equal; at 64x128 and 112x128 also as 2 slabs
     (parallel.make_sharded_renderer), equal to the frame bit for bit; each render kernel of its path against its plain
     version (phase 1's budgets) and into guarded outputs, its device ms
     (one torch.profiler session) and for raster and plan its bound. One
     line per configuration with the card's name and power limit. Then
     python -m tpurast_torch.cli --scene orbit --tile-h 112 --tile-w 128
     in-process, 16 frames: parity within 1 LSB, no dropped pairs, every
     render kernel launched. Every kernel of a configuration's path must
     launch once per frame, and a gather or deferred configuration holds
     its shade kernel to its plain version (as 1c);
 1c. shade_kernels: the gather and deferred kernels (csrc/shade.cu) on
     frame 0's inputs against their plain versions with the atlas rows in
     each texel dtype (float32, float16, bfloat16, srgb8) at anisotropy 16
     and float16 at 1: within 1 LSB after the sRGB u8 encode, the clear
     color exact, the pixels that differ in f32 and those at 1 LSB
     counted; the deferred kernel equal bit for bit to the gather kernel on
     the resolve kernel's G-buffer; the middle slab's (the second of four,
     at its y_offset) frames equal to the frame's rows; each into guarded
     outputs; their ms and device ms (profiled again, up to four profiles
     in all, where torch.profiler drops the record) beside the plain
     versions' and their bound, the L1 requests of their row reads
     (shade_warp_lines: the kernels' loads beside one load a texel, and for
     deferred its face rows), and each instance's registers, blocks per SM,
     threads and shared memory per block;
  2. runs the microbenchmark probes at the tools' sizes against their
     plain versions, bit for bit: vmem_take (4096x16 f32 table, 2,073,600
     indices; then an odd row count, a count of indices that fills no whole
     warp, indices outside the table and an index array off the 16-byte
     grid) and plane_scale on a (24, 1088, 1920) G-buffer in its three
     launch geometries;
  3. the window main path: renders a warm-up frame plus 8 frames of an
     orbiting camera through tpurast_torch.renderer.Renderer (the warm-up
     frame renders eagerly and captures the Renderer's CUDA graph, the 8
     replay it), checks that every render kernel's launch counter rose by
     one per frame, that nothing overflowed and that 5-95% of the pixels
     are covered; then the graph frames (graph_frames): each of the 8
     equal to render_frame's eager frame bit for bit (color, depth,
     bin_overflow, window_miss_px), two frames held at once (cameras 0
     and 1, both replayed before either is read) each equal to its eager
     frame with one launch per kernel a frame, torch.profiler over one
     replay listing the raster, resolve, plan and sample kernels once
     each, the debug_gbuf graph equal to the eager G-buffer, 3 frames at
     1280x720 after recreate_swapchain equal to their eager frames, and
     the graph's capture ms, pool bytes, frame median against the eager
     frame's (events), host ms per render call and device idle share;
     then frame 0 inside plain_kernels(): no kernel launched, color within
     1 LSB of the graph frame, depth exact;
  4. the microbenchmark path: tools.microbench's vmemtake and
     tools.microbench_pipeline's run, with the probe counters from zero
     (each kernel must launch), and tools.microbench's shade
     decomposition over the orbit scene's f16 atlas rows;
  5. the gather path (sampler="gather"): a warm-up frame plus 3 track
     frames (graph replays, each equal to its eager frame bit for bit,
     with the graph's costs as in 3); raster, resolve and gather launch
     once per frame, plan, sample and deferred never; no overflow; depth
     equal to the window path's; frame 0 within 2 LSB of the window path's frame 0 (the
     reference's budget between its two samplers, tests/test_sampler.py:76);
  6. the deferred path (shading="deferred"), the same frames and graph
     checks: raster and deferred launch once per frame and nothing else;
     color and depth equal to the gather path's bit for bit;
  7. the runtime path: tpurast_torch.cli.main in-process for --scene orbit
     at 1920x1080, 32 frames after 4 warm-up frames, with --stages. Its JSON
     line is printed and checked: parity_max_lsb <= 1, dropped_pairs 0,
     backend "cuda", capture_ms and graph_pool_bytes set, and every render
     kernel's launch counter equal to the frames the run rendered (gate,
     warm-up, timed loop, present loop), the probes' at 0; its stage_ms
     (the timed frames' stage marks) is printed beside the window stages'
     eager device ms. Then an
     Engine at its default 1280x720 over the same scene for 8 ticks under a
     scripted controller: None first, every later image (720, 1280, 4) u8,
     nothing dropped, the camera moved, and the last presented image equal
     to render_to_host of the same camera; a Presenter given CUDA frames
     of changing shapes hands each back as given. The read-back's copy is timed
     alone (one 1080p frame into pinned memory) beside the bench's
     present_ms_per_frame and p50_frame_ms;
  8. slabs and scan (after phase 6, on its renderers): raster and resolve
     at a global row offset (the second slab of a 4-slab split of frame
     0) against their plain versions (raster exact; resolve integer planes
     exact, float planes phase 1's rule) and against the same rows of the
     whole frame, bit for bit; parallel.make_sharded_renderer (a CUDA
     graph) with 2 and 8 slabs on the window path and 2 on gather and on
     deferred, its eager first frame and its replay each equal to the
     single Renderer frame bit for bit with the same counters, raster
     (resolve, plan, sample, gather, deferred where the path has them)
     launched once per slab in the replay; Renderer(binning="scan"): a warm-up and 3 track frames
     (graph replays, equal to their eager frames) equal to the pairs
     frames, frame 0's counts, offsets and
     per-tile face sets equal to bin_pairs', and a pair buffer of half the
     pairs counting the rest in overflow while the frame renders; the
     binning stage's event ms under each binner and the slab frames' ms
     beside the single frame's, with the card's name and power limit. The
     slabs of one card run concurrently, each on a stream of its own
     inside the graph. Then multi_device: make_sharded_renderer over a
     device list (cuda:0..n-1 where the machine has two cards or more,
     else 4 entries of cuda:0; the line says which) on the window,
     gather and deferred paths, its eager first frame and its replay equal to the
     single frame bit for bit, one launch per slab of each render kernel
     the path runs, its graph ms beside the single frame's and the
     sequential 4-slab graph's (the slabs one after another, as before
     they ran concurrently), capture ms, pool bytes and replica bytes;
  9. the analysis tools (tpurast_torch/tools: profile_stages,
     sample_stage_probe, profile_sampler, sampler_plan_stats,
     check_sampler, aniso_mode_stats, residual_analysis, sampler_sim)
     once each in-process on the scene already built, at 1920x1080
     (check_sampler at its 256x128) and 2 frames, their lines printed
     (sample_stage_probe and profile_sampler time CUDA graphs, as the
     reference times jitted functions);
 10. the pose tools (pose_tools), at frame sizes off the 128-px tile grid:
     parity_render.render_poses on 3 orbit poses at 1282x721 (the
     screenshots' size, padded to 1408x736) and 320x180 (padded to
     384x192), one launch of each render kernel per pose, color within
     1 LSB of the plain versions, depth equal, no overflow, the
     side_by_side shape; at each size the padded frame before the crop
     (debug_gbuf's G-buffer and face ids, then plan and sample on it)
     against the plain versions, the pixels past the frame counted
     apart; the 1282x721 graph frame's ms beside the 1280x720 one's
     (events); then fit_pose.fit for 200 poses at 320x180 toward the
     coverage mask of orbit_camera(0.7) (centre (0, 1, 0), radii
     10.5-13, steps 1.0): one launch of each render kernel per pose,
     the true pose's mask IoU exactly 1.0 after the replays, ms per pose
     (a replay and the mask's read-back, host clock) and poses per second
     beside the device's busy time, capture ms; the first 40 iterations
     with the kernels and inside plain_kernels() giving the same
     improvement lines, best pose and IoU;
 11. the sanitizer phase: compute-sanitizer (PATH, else
     /usr/local/cuda/bin) is first tried on one small torch program under
     memcheck. Where it attaches, the case set (sanitize_cases: frame 0 at
     1920x1080, 1282x721 and 320x180, the 2- and 8-slab frames, the scan
     path, the mesh frame, and the probes at odd shapes, each eagerly and
     as a graph replay, equal bit for bit) runs in a subprocess under its
     memcheck (leaks not checked), racecheck and synccheck, each with
     --error-exitcode 1, and any error fails the run; where it is absent
     or cannot attach, a line says so and the case set runs once without
     a tool. One line per run: cases, errors, seconds.
 12. the named scenes (named_scenes, before the sanitizer phase): a
     stand-in for the reference's data directory written at full scale
     with stored zstd frames into a temporary directory
     (tpurast_torch.tools.standin_data; not the reference's data), the
     committed zstd fixtures of tests/data/zstd decoded by the port's
     decoder against their SHA-256, then demo, porsche_class, hdr and
     dragons64 loaded through load_named_scene (build seconds, peak host
     RSS, faces, texels, page and atlas bytes; the window path builds no
     quad rows) and rendered at their cli.ALL_CONFIGS sizes (3840x2160
     for dragons64) with each render kernel against its plain version
     there (phase 1's checks and guard bands) and the graph frame's costs;
     porsche_class's gather path with texture_dtype "auto" (srgb8; the
     rows' first read timed) within 2 LSB of the window frame and its
     deferred path equal to it, both shade kernels on its srgb8 rows
     against their plain versions (1c's checks); hdr's page above 1.0 with "auto" at
     float16; `python -m tpurast_torch.cli --all --data-dir` on the
     directory, its five lines printed as stand-ins; and entry(directory)
     equal to Renderer.render bit for bit.

Every kernel-against-plain phase (kernel_phases, shade_kernels,
config_matrix, probe_phases, slab_kernels, padded_kernels, named_scenes)
also launches each kernel once more with its outputs and scratch as views
inside larger buffers whose every byte
was 0xA5 (guard bands, up to 2^20 elements on each side): the margins must
still hold 0xA5 afterwards and the views equal the wrapper's outputs bit
for bit.

The run writes nothing but the builds under tpurast_torch/_build (the
kernels, the native BC and zstd decoders): the scene cache is off
(TPURAST_TORCH_SCENE_CACHE=0 unless the caller set it), and the tools'
G-buffer dump and the stand-in data directory live in temporary
directories that the run removes. The whole run takes about
five minutes on an H100 (config_matrix about 50 s of it; the pose tools
about 30 s, 11 s of that the plain versions' 40 poses; the named scenes
about two and a half minutes, one of them the bench's five subprocesses;
the sanitizer phase about 30 s without a tool); should it ever pass 600 s,
the tools' frame counts are the first to cut, then the gather and deferred
phases from 4 frames to 2.

Each path prints its frame times and a per-stage breakdown; the window
path also prints, per stage, the device operations torch.profiler counts
and their device time beside the stage's event time. Earlier lines give
the plan, sample, shade and vmem_take kernels' registers and resident
blocks per SM, the plan's windows-per-tile histogram and the probes a warp runs (its worst
lane's) beside the mean per pixel. Each kernel
also gets its bound: the larger of the bytes it must move over the card's
memory rate and its f32 operations over the f32 peak (HBM_BYTES_PER_S,
F32_FLOPS), from this run's inputs (plan and sample: the planes the
function needs, not all 24, and for sample the distinct page texels its
probes touch; the earlier count is printed beside it; the shade kernels:
one atlas row per probe the covered pixels run); the raster line adds the densest
tile's pair count, the (pair, pixel) evaluations of the pairs' pixel
rectangles and the kernel's device time by operation, and plane_scale is
timed beside torch.mul(gbuf[plane], 2), the one PyTorch call that computes
the same. Any failure raises. The last stdout line is {"ok": true,
"device": ...}; the line before it lists each kernel's launches (on the
window path for the render kernels, on the gather or deferred path for
the shade kernels, on the microbenchmark path for the probes;
runtime_launches on the bench run, slab_launches on the 8-slab window
frame (a shade kernel: its path's 2-slab frame), mesh_launches on
multi_device's window replay (a shade kernel: its path's replay),
scan_launches on the scan track, pose_launches on the 200-pose search),
error, times, bound and library time.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpurast_torch import cli  # noqa: E402
from tpurast_torch import kernels as K  # noqa: E402
from tpurast_torch.camera import Camera, MoveDirection  # noqa: E402
from tpurast_torch.config import RendererConfig  # noqa: E402
from tpurast_torch import parallel, tracing  # noqa: E402
from tpurast_torch.assets.gltf import load_glb  # noqa: E402
from tpurast_torch.device.scene import (build_orbit_scene, build_scene, orbit_camera, orbit_track,  # noqa: E402
                                       scene_bytes)
from tpurast_torch.device.scene_cache import load_named_scene  # noqa: E402
from tpurast_torch.device.textures import ROW_WIDTH, texels_tensor  # noqa: E402
from tpurast_torch.engine import Engine  # noqa: E402
from tpurast_torch.graphs import FrameGraph, Graph  # noqa: E402
from tpurast_torch.kernels import _build, geometry, present, probes, raster, resolve, sampler, shade  # noqa: E402
from tpurast_torch.parallel import make_sharded_renderer  # noqa: E402
from tpurast_torch.present import Presenter  # noqa: E402
from tpurast_torch.renderer import Renderer, render_frame  # noqa: E402
from tpurast_torch.tools import (aniso_mode_stats, check_sampler, fit_pose, microbench,  # noqa: E402
                                 microbench_pipeline, parity_render, profile_sampler, profile_stages,
                                 residual_analysis, sample_stage_probe, sampler_plan_stats, sampler_sim)
from tpurast_torch.tools.microbench import device_ms  # noqa: E402

KERNELS = {
    "raster": ("tpurast_torch/csrc/raster.cu", "tpurast/kernels/raster.py:88"),
    "resolve": ("tpurast_torch/csrc/resolve.cu", "tpurast/kernels/resolve.py:126"),
    "plan": ("tpurast_torch/csrc/plan.cu", "tpurast/kernels/sampler.py:230"),
    "sample": ("tpurast_torch/csrc/sampler.cu", "tpurast/kernels/sampler.py:650"),
    # No pallas_call: the reference leaves these two to XLA.
    "gather": ("tpurast_torch/csrc/shade.cu", "tpurast/kernels/shade.py:463"),
    "deferred": ("tpurast_torch/csrc/shade.cu", "tpurast/kernels/shade.py:316"),
    "vmem_take": ("tpurast_torch/csrc/probes.cu", "tools/microbench.py:262"),
    "plane_scale": ("tpurast_torch/csrc/probes.cu", "tools/microbench_pipeline.py:35"),
}
RENDER_KERNELS = ("raster", "resolve", "plan", "sample")
SHADE_KERNELS = ("gather", "deferred")
# The kernels each frame path launches once per frame (or slab).
PATH_KERNELS = {"window": RENDER_KERNELS, "gather": ("raster", "resolve", "gather"), "deferred": ("raster", "deferred")}
# The card's published peaks (H100 SXM at 700 W): device memory bytes/s
# and f32 FLOP/s outside the tensor cores. A kernel's bound is the larger of its bytes and its operations
# over these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per evaluated (pair, pixel) of the raster kernel: three
# edge functions, their sum, the depth and w numerators, the w test and
# the division (csrc/raster.cu).
RASTER_FLOPS_PER_EVAL = 40
# Bytes of one face the raster kernel must read: setup fields 0-17 (edges,
# z, w, face id, anchor; kRowFields in csrc/raster.cu) and its AABB.
RASTER_FACE_BYTES = 18 * 4 + 4 * 4
PROBE_KERNELS = ("vmem_take", "plane_scale")
# The shade kernels (csrc/shade.cu): f32 operations of one probe (a
# trilerp: the 13 texels' weighted sums, the weights and the addressing)
# and of a covered pixel's lighting; deferred adds the edge functions,
# interpolation, derivatives and footprint of a covered pixel.
SHADE_FLOPS_PER_PROBE = 160
SHADE_FLOPS_PER_PIXEL = 80
DEFERRED_FLOPS_PER_PIXEL = 150
GATHER_PLANES = 18  # G-buffer planes 0-17 the gather kernel reads
# shade_warp_lines: the bytes of an L1 line (one request per distinct line
# a warp-wide load touches); the deferred kernel's loads of its face row
# per covered pixel: one a field (fields 0-8, 16, 17, world, normal and uv,
# widths, heights and mip count at level 0, and five fields at the pixel's
# levels l0 and l1), or csrc/shade.cu's 13 16-byte loads and the five level
# fields.
L1_LINE = 128
FIELD_FACE_LOADS = 43
FACE_LOADS = 18
SHADE_DTYPES = ("float32", "float16", "bfloat16", "srgb8")  # the atlas row formats
FRAMES = 8
GATHER_FRAMES = 3
SCAN_FRAMES = 3
SLAB_SPLIT = 4  # raster and resolve at an offset: the second slab of this many
SLABS = {"window": (2, 8), "gather": (2,), "deferred": (2,)}  # slab counts per path
MESH_SLABS = 4  # multi_device's slabs on a machine with one card
WIDTH, HEIGHT = 1920, 1080
GRAPH_OUTPUTS = ("color", "depth", "bin_overflow", "window_miss_px")  # compared bit for bit with eager frames
FLOAT_PLANES = [i for i in range(resolve.A_OUT) if i not in resolve.INT_PLANES]
POSE_W, POSE_H = 320, 180  # fit_pose's frame: pads to 384x192
POSE_ITERS, POSE_PLAIN_ITERS = 200, 40
POSE_TRUE = 0.7  # orbit_camera angle of the pose the search looks for
# The search on the orbit scene: centred on orbit_camera's target, radii
# around the track's 11.77 units from it (11.5 out, 2.5 up), steps scaled
# up from the reference's 0.08 as its radii are.
POSE_SEARCH = dict(center=(0.0, 1.0, 0.0), rmin=10.5, rmax=13.0, sigma=1.0)
# The screenshots' client area (pads to 1408x736: the 11th tile column
# holds 2 frame columns) and fit_pose's frame.
PARITY_SIZES = ((1282, 721), (POSE_W, POSE_H))
PARITY_ANGLES = (0.7, 2.1, 4.0)
# G-buffer planes the functions read: the plan 6, 7, 9-12, 14-17, 20-23; the
# sample those and 0-5 and 13 (csrc/plan.cu, csrc/sampler.cu).
PLAN_PLANES = 14
SAMPLE_PLANES = 21
# Guard bands around a guarded launch's outputs (guarded): elements on each
# side (a tile row of a 1920-wide frame is 61,440) and the byte they hold.
GUARD_ELEMS = 1 << 20
GUARD_BYTE = 0xA5


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls, by CUDA events,
    after one warm-up call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ops(fn, reps: int) -> dict:
    """Device milliseconds per call of fn by operation name (torch.profiler
    over reps calls after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages() if e.self_device_time_total > 0}


def device_ms_retried(fn, reps: int, tries: int = 4) -> float | None:
    """microbench.device_ms, profiled again (up to tries profiles in all)
    while torch.profiler records no device time for fn."""
    for _ in range(tries):
        ms = device_ms(fn, reps)
        if ms is not None:
            return ms
    return None


def timed(kernel_fn, plain_fn, reps: int, plain_reps: int) -> dict:
    """A kernel's and its plain version's ms per call by CUDA events (ms,
    plain_ms: what a caller waits, launch overhead included) and by the
    profiler's device time (dev_ms, plain_dev_ms; device_ms_retried)."""
    return dict(
        ms=cuda_ms(kernel_fn, reps), plain_ms=cuda_ms(plain_fn, plain_reps),
        dev_ms=device_ms_retried(kernel_fn, reps), plain_dev_ms=device_ms_retried(plain_fn, plain_reps),
    )


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def raster_work(so, bins, th, tw, tx) -> dict:
    """Pairs, the distinct faces they name, the densest tile's pair count,
    the (pair, pixel) evaluations the raster kernel makes (each pair's
    pixel rectangle, raster.pixel_rects, clamped to its tile) and its work
    units (tile, sub-rectangle, chunk of pairs)."""
    n = int(bins["offsets"][-1])
    faces = bins["pair_faces"][:n].long()
    tiles = torch.searchsorted(bins["offsets"][1:].long(), torch.arange(n, device=faces.device), right=True)
    r = raster.pixel_rects(so["aabb"])[faces]
    gx0 = ((tiles % tx) * tw).float()
    gy0 = ((tiles // tx) * th).float()
    w = torch.minimum(r[:, 2], gx0 + (tw - 1)) - torch.maximum(r[:, 0], gx0) + 1
    h = torch.minimum(r[:, 3], gy0 + (th - 1)) - torch.maximum(r[:, 1], gy0) + 1
    evals = int((w.clamp(min=0).double() * h.clamp(min=0).double()).sum())
    _, _, nx, ny = raster.tile_subs(th, tw)
    units = nx * ny * int(((bins["counts"] + raster.UNIT_PAIRS - 1) // raster.UNIT_PAIRS).sum())
    return dict(pairs=n, faces=int(torch.unique(faces).numel()), densest=int(bins["counts"].max()), evals=evals,
                units=units)


def raster_bound(work: dict, n_tiles: int, hp: int, wp: int) -> dict:
    """The raster kernel's bound: each input read once (the named faces'
    rows and AABBs, the pair list and offsets), the (2, Hp, Wp) output
    written once; RASTER_FLOPS_PER_EVAL per evaluated (pair, pixel)."""
    return bound(work["faces"] * RASTER_FACE_BYTES + work["pairs"] * 4 + (n_tiles + 1) * 4 + 2 * hp * wp * 4,
                 work["evals"] * RASTER_FLOPS_PER_EVAL)


def plan_bound(hp: int, wp: int, n_matched: int, plan: dict) -> dict:
    """The plan kernel's bound for what a frame needs: the match plane read
    at every pixel, the other PLAN_PLANES - 1 planes at the matched pixels,
    the table and assignment written; its reductions are a few operations
    per pixel and round."""
    out_bytes = plan["table"].numel() * 4 + plan["assign"].numel() * 4
    return bound(hp * wp * 4 + (PLAN_PLANES - 1) * n_matched * 4 + out_bytes, hp * wp * 100)


def resolve_disagreement(g, g_p, covered) -> tuple[int, int, int]:
    """The resolve kernel's G-buffer g against its plain version's g_p:
    (covered pixels whose mip level l0 flipped, integer-plane values that
    differ and float-plane values outside rtol 1e-5 / atol 1e-6, both away
    from the flipped pixels). The budget: flips at most 0.1% of the covered
    pixels, the other two 0."""
    flip = (g[19] != g_p[19]) & covered
    keep = ~flip
    int_bad = int(sum(((g[i] != g_p[i]) & keep).sum() for i in resolve.INT_PLANES))
    float_bad = int((~torch.isclose(g[FLOAT_PLANES][:, keep], g_p[FLOAT_PLANES][:, keep], rtol=1e-5,
                                    atol=1e-6)).sum())
    return int(flip.sum()), int_bad, float_bad


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Out:
    """An output or scratch argument of a guarded launch: a tensor of this
    shape and dtype, zeroed first where the kernel adds to it."""

    def __init__(self, shape, dtype=torch.float32, zero: bool = False):
        self.shape, self.dtype, self.zero = tuple(shape), dtype, zero


def guarded(entry: str, *args, want=()) -> dict:
    """One more launch of C entry point ``entry`` (through _build.call, so
    no launch is counted) with each Out argument a view inside a larger
    buffer: GUARD_ELEMS elements (at most; as many as the view holds if
    fewer, rounded up to a whole 256 B) on each side, every byte of the
    buffer set to GUARD_BYTE first. Afterwards the margins must still hold
    GUARD_BYTE (nothing written before or past an output), and the views
    equal ``want`` (the wrapper's own outputs, in the order of the Out
    arguments; None where a scratch buffer has no counterpart) bit for
    bit. Returns {"intact": bool, "same": bool}."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    bufs, conv = [], []
    for a in args:
        if not isinstance(a, Out):
            conv.append(a)
            continue
        n = int(np.prod(a.shape))
        es = torch.empty((), dtype=a.dtype).element_size()
        per = 256 // es
        m = -(-min(max(n, 1), GUARD_ELEMS) // per) * per
        buf = torch.empty((n + 2 * m,), dtype=a.dtype, device=dev)
        buf.view(torch.uint8).fill_(GUARD_BYTE)
        view = buf[m:m + n].view(a.shape)
        if a.zero:
            view.zero_()
        bufs.append((buf, m * es, view))
        conv.append(view)
    _build.call(entry, *conv)
    torch.cuda.synchronize()
    intact = all(bool((b.view(torch.uint8)[:mb] == GUARD_BYTE).all())
                 and bool((b.view(torch.uint8)[b.numel() * b.element_size() - mb:] == GUARD_BYTE).all())
                 for b, mb, _ in bufs)
    same = all(w is None or bool(torch.equal(v, w)) for (_, _, v), w in zip(bufs, want))
    return dict(intact=intact, same=same)


GUARDS: list = []  # (phase, kernel, result of guarded) of the run


def guard(phase: str, kernel: str, entry: str, *args, want=()) -> None:
    """guarded(), recorded in GUARDS and held by check()."""
    res = guarded(entry, *args, want=want)
    GUARDS.append((phase, kernel, res))
    check(res["intact"], f"{phase}: {kernel} wrote into a guard band")
    check(res["same"], f"{phase}: {kernel} in a guarded buffer differs from the wrapper's output")


def guard_raster(phase: str, so, bins, vis, *, tile_h, tile_w, tiles_x, tiles_y, clear_depth, tile_row_offset=0):
    """The raster kernel into guarded scratch and output, against vis."""
    slots = bins["pair_faces"].numel()
    keys, work, _ = raster.kernel_buffers(tile_h, tile_w, tiles_x, tiles_y, slots, "meta")
    guard(phase, "raster", "tr_raster", so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], slots,
          tiles_x, tiles_y, tile_h, tile_w, tile_row_offset, float(clear_depth) + 0.0, Out(keys.shape, torch.int64),
          Out(work.shape, torch.int32), work.numel(), Out(vis.shape), None, None, want=(None, None, vis))


def guard_resolve(phase: str, vis, attrs, g, *, max_anisotropy, y_offset=0):
    _, hp, wp = vis.shape
    guard(phase, "resolve", "tr_resolve", vis, attrs, attrs.shape[0], hp, wp, y_offset, max_anisotropy,
          Out(g.shape), None, None, want=(g,))


def guard_plan(phase: str, g, plan, *, tiles_x, tiles_y, tile_h, tile_w, max_anisotropy):
    scratch = sampler.plan_scratch(tile_h, tile_w, g.shape[1], g.shape[2], "meta")
    guard(phase, "plan", "tr_plan", g, tiles_x, tiles_y, tile_h, tile_w, sampler.rc_for(tile_h), max_anisotropy,
          Out(plan["table"].shape, torch.int32), Out(plan["assign"].shape), Out((), torch.int32, zero=True),
          None if scratch is None else Out(scratch.shape, torch.int32),
          want=(plan["table"], plan["assign"], plan["residual_px"], None))


def guard_sample(phase: str, g, page, plan, cp, fb, *, tiles_x, tiles_y, tile_h, tile_w, max_anisotropy, **light):
    params = (ctypes.c_float * shade.N_PARAMS)(*shade.shade_params(**light))
    guard(phase, "sample", "tr_sample", g, page, page.shape[2], plan["table"], cp, tiles_x, tiles_y, tile_h, tile_w,
          max_anisotropy, ctypes.addressof(params), Out(fb.shape), None, None, want=(fb,))


def print_guards(phase: str, card: str) -> None:
    mine = [(k, r) for p, k, r in GUARDS if p == phase]
    print(f"guard bands, {phase}: " + ", ".join(f"{k} intact {r['intact']} equal {r['same']}" for k, r in mine)
          + f" (up to {GUARD_ELEMS} elements of 0x{GUARD_BYTE:02X} bytes on each side of each output) [{card}]")


def path_want(label: str, n: int) -> dict:
    """Each kernel's launches for n frames (or slabs) of a frame path."""
    return {name: n if name in PATH_KERNELS[label] else 0 for name in KERNELS}


def path_of(r: Renderer) -> str:
    """r's frame path: "window", "gather" or "deferred"."""
    return "deferred" if r.config.shading == "deferred" else r.sampler


def light_kwargs(kw: dict) -> dict:
    """The lighting and blend arguments of a Renderer's frame arguments."""
    return dict(light_direction=kw["light_direction"], light_color=kw["light_color"],
                ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
                clear_color=kw["clear_color"], blend=kw["blend"])


def shade_rows_touched(g, n_rows: int, ma: int) -> tuple[int, int]:
    """The probes the covered pixels of G-buffer g run (shade.probe_count)
    and the distinct atlas rows they read (shade_items). The deferred
    kernel recomputes the same fields bit for bit (deferred = forward +
    gather), so both kernels read these rows."""
    _, _, r = shade_items(g, n_rows, ma)
    return r.numel(), int(torch.unique(r).numel())


def shade_items(g, n_rows: int, ma: int) -> tuple:
    """The probes the covered pixels of G-buffer g run (the plain version's
    trip count: probes i < max_anisotropy with i < n_px) as (pixel of the
    flattened frame, probe index, row) tensors, each probe's row by the
    plain _trilerp's clamped addressing."""
    hw = g.shape[1] * g.shape[2]
    pix = torch.nonzero(g[16].reshape(-1) > 0)[:, 0]
    c = g.reshape(g.shape[0], hw)[:, pix]
    off0, tw0, th0 = c[8].to(torch.int32) * 256, c[9].to(torch.int32), c[10].to(torch.int32)
    npx = shade.probe_count(c[17], c[14], c[15], c[9], c[10], ma) if ma > 1 else torch.ones_like(c[6])
    items = []
    for i in range(max(ma, 1)):
        live = npx > float(i)
        fo = (shade.fdiv(i + 0.5, npx) - 0.5) * c[17] if ma > 1 else torch.zeros_like(c[6])
        x0 = torch.floor((c[6] + c[14] * fo) * tw0.to(torch.float32) - 0.5)
        y0 = torch.floor((c[7] + c[15] * fo) * th0.to(torch.float32) - 0.5)
        x0i = torch.remainder(x0.to(torch.int32), torch.clamp(tw0, min=1))
        y0i = torch.remainder(y0.to(torch.int32), torch.clamp(th0, min=1))
        row = torch.clamp(off0 + y0i * tw0 + x0i, 0, n_rows - 1)
        items.append((pix[live], torch.full_like(pix[live], i), row[live].long()))
    return tuple(torch.cat(t) for t in zip(*items))


def shade_warp_lines(kind: str, g, fid, texels, ma: int) -> dict:
    """L1 requests of a shade kernel's reads at frame g (fid: face ids),
    per warp of 32 consecutive pixels (the kernels' thread order), counting
    one request per distinct 128-byte line a warp-wide load touches (rows
    from a 128-byte aligned base), for each probe index:
      * texel_lines: the atlas rows read a load a texel (the first design
        of these kernels): for each texel k, the distinct lines the lanes
        with a probe i read;
      * lines: the rows as csrc/shade.cu reads them: 16-bit rows six
        16-byte loads and one 8-byte load, srgb8 rows six 8-byte loads and
        one 4-byte load (offsets by the row's parity), float32 rows 13
        16-byte loads; for each load, the distinct lines of the lanes;
      * field_face_lines, face_lines (deferred): FIELD_FACE_LOADS and
        FACE_LOADS loads of each covered pixel's face row, each a request
        per distinct face of the warp.
    With the ms each implies at one request per SM clock over the card's
    SMs (sm_clock)."""
    p, i, r = shade_items(g, texels.shape[0], ma)
    chunk = texels.shape[1] * texels.element_size() // 13  # one texel's bytes
    warp = p // 32

    def requests(lines):  # lines: (items, loads)
        load = torch.arange(lines.shape[1], device=lines.device)
        return int(torch.unique((((warp * max(ma, 1) + i)[:, None] * 16 + load) << 32) | lines).numel())

    k = torch.arange(13, device=p.device)
    per_texel = ((r[:, None] * 13 + k) * chunk) // L1_LINE
    if chunk == 16:
        wide = per_texel
    else:
        odd = (r & 1)[:, None]
        j = torch.arange(7, device=p.device)
        offs = torch.where(j < 6, odd * chunk + j * 2 * chunk, (1 - odd) * 12 * chunk)
        wide = (r[:, None] * 13 * chunk + offs) // L1_LINE
    out = dict(texel_lines=requests(per_texel), lines=requests(wide))
    if kind == "deferred":
        px = torch.nonzero(fid.reshape(-1) >= 0)[:, 0]
        faces = int(torch.unique((px // 32) << 32 | fid.reshape(-1)[px].long()).numel())
        out.update(field_face_lines=FIELD_FACE_LOADS * faces, face_lines=FACE_LOADS * faces)
    sms, hz, _ = sm_clock()
    return {**out, **{f"{key}_ms": n / (sms * hz) * 1e3 for key, n in out.items()}}


@functools.cache
def sm_clock() -> tuple[int, float, str]:
    """(SMs, SM clock in Hz, where the clock came from) of card 0:
    torch.cuda.get_device_properties' clock_rate where torch has it, else
    nvidia-smi's maximum SM clock."""
    props = torch.cuda.get_device_properties(0)
    khz = getattr(props, "clock_rate", None)
    if khz:
        return props.multi_processor_count, khz * 1e3, "torch.cuda.get_device_properties clock_rate"
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return props.multi_processor_count, float(smi.stdout.strip()) * 1e6, "nvidia-smi clocks.max.sm"


def fmt_lines(st: dict) -> str:
    """shade_warp_lines' counts with the ms each implies."""
    sms, hz, _ = sm_clock()
    face = (f"; face rows {st['face_lines']} ({st['face_lines_ms']:.4f} ms; a load a field: "
            f"{st['field_face_lines']}, {st['field_face_lines_ms']:.4f} ms)" if "face_lines" in st else "")
    return (f"L1 requests (shade_warp_lines, at {hz / 1e9:.3f} GHz x {sms} SMs): atlas rows {st['lines']} "
            f"({st['lines_ms']:.4f} ms; a load a texel: {st['texel_lines']}, {st['texel_lines_ms']:.4f} ms)"
            f"{face}")


def shade_bound(kind: str, g, fid, texels, ma: int) -> dict:
    """The gather or deferred kernel's bound for what this frame needs:
    gather reads the match plane at every pixel and the other
    GATHER_PLANES - 1 planes at a covered one, deferred the face id at
    every pixel and each distinct face's 104-float row once; both each
    distinct 52-channel atlas row the probes read once (shade_rows_touched)
    and the srgb8 decode table, and write the 4 output planes; per probe
    SHADE_FLOPS_PER_PROBE, per covered pixel its lighting (and for deferred
    its interpolation). Adds the probe and distinct row counts and
    shade_warp_lines' request counts."""
    hp, wp = fid.shape
    covered = int((fid >= 0).sum())
    probes, rows = shade_rows_touched(g, texels.shape[0], ma)
    row_bytes = rows * texels.shape[1] * texels.element_size() + (256 * 4 if texels.dtype == torch.uint8 else 0)
    if kind == "gather":
        nbytes = hp * wp * 4 + (GATHER_PLANES - 1) * covered * 4
        flops = covered * SHADE_FLOPS_PER_PIXEL
    else:
        nbytes = hp * wp * 4 + int(torch.unique(fid[fid >= 0]).numel()) * shade.SHADE_ROW_WIDTH * 4
        flops = covered * (SHADE_FLOPS_PER_PIXEL + DEFERRED_FLOPS_PER_PIXEL)
    return dict(probes=probes, rows=rows, **shade_warp_lines(kind, g, fid, texels, ma),
                **bound(nbytes + row_bytes + 4 * hp * wp * 4, flops + probes * SHADE_FLOPS_PER_PROBE))


def shade_compare(out, want, covered) -> dict:
    """A shade kernel's framebuffer against its plain version's: linear max
    abs error, pixels whose f32 planes differ, max LSB after the sRGB u8
    encode and pixels at 1 LSB, and whether the uncovered pixels hold the
    same clear color."""
    h, w = out.shape[1:]
    lsb = (present.encode_srgb_u8(out, w, h).int() - present.encode_srgb_u8(want, w, h).int()).abs().amax(dim=0)
    return dict(max_abs_err=float((out - want).abs().max()), px_differ=int((out != want).any(dim=0).sum()),
                lsb=int(lsb.max()), px_at_1=int((lsb == 1).sum()),
                clear_equal=bool(torch.equal(out[:, ~covered], want[:, ~covered])))


def fmt_compare(c: dict) -> str:
    return (f"max abs {c['max_abs_err']:.3g}, {c['px_differ']} px differ in f32, max {c['lsb']} LSB "
            f"({c['px_at_1']} px at 1), clear color equal {c['clear_equal']}")


def guard_shade(phase: str, kind: str, fb, texels, texel_format: str, lut, cp, ma: int, light: dict, *, g=None,
                fid=None, rows=None, y_offset: int = 0) -> None:
    """tr_shade_gbuffer (G-buffer g) or tr_shade_deferred (fid, rows) into
    a guarded output, against the wrapper's fb."""
    code, lut = shade._check_rows(texels, texel_format, lut)
    params = (ctypes.c_float * shade.N_PARAMS)(*shade.shade_params(**light))
    h, w = fb.shape[1:]
    if kind == "gather":
        guard(phase, kind, "tr_shade_gbuffer", g, texels, texels.shape[0], code, lut, cp, h, w, ma,
              ctypes.addressof(params), Out(fb.shape), None, None, want=(fb,))
    else:
        guard(phase, kind, "tr_shade_deferred", fid, rows, rows.shape[0], texels, texels.shape[0], code, lut, cp, h,
              w, y_offset, ma, ctypes.addressof(params), Out(fb.shape), None, None, want=(fb,))


def shade_pair(phase: str, vis, attrs, rows, texels, texel_format: str, lut, cp, ma: int, light: dict, *,
               tile_row_offset: int = 0, tile_h: int | None = None) -> dict:
    """Both shade kernels on one frame's (or slab's) raster output vis
    against their plain versions: within 1 LSB after the sRGB u8 encode,
    the clear color exact (shade_compare); the deferred kernel equal bit
    for bit to the gather kernel on the resolve kernel's G-buffer (deferred
    = forward + gather); each launched once more into a guarded output.
    lut is the srgb8 rows' decode table (shade.srgb_table), else None.
    Returns the G-buffer, face ids, both frames and the comparisons."""
    y_offset = tile_row_offset * tile_h if tile_row_offset else 0
    g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma, tile_row_offset=tile_row_offset, tile_h=tile_h)
    fid = vis[1].to(torch.int32)
    covered = fid >= 0
    kw = dict(max_anisotropy=ma, texel_format=texel_format, **light)
    fb = shade.shade_gbuffer(g, texels, cp, srgb_lut=lut, **kw)
    d = shade.shade_deferred(fid, rows, texels, cp, y_offset=y_offset, srgb_lut=lut, **kw)
    cmp = {"gather": shade_compare(fb, shade.shade_gbuffer_plain(g, texels, cp, **kw), covered),
           "deferred": shade_compare(d, shade.shade_deferred_plain(fid, rows, texels, cp, y_offset=y_offset, **kw),
                                     covered)}
    same = bool(torch.equal(d, fb))
    for kind, c in cmp.items():
        check(c["lsb"] <= 1 and c["clear_equal"], f"{phase}: the {kind} kernel disagrees with its plain version")
    check(same, f"{phase}: the deferred kernel differs from the gather kernel on the resolve kernel's G-buffer")
    guard_shade(phase, "gather", fb, texels, texel_format, lut, cp, ma, light, g=g)
    guard_shade(phase, "deferred", d, texels, texel_format, lut, cp, ma, light, fid=fid, rows=rows, y_offset=y_offset)
    return dict(g=g, fid=fid, gather=fb, deferred=d, cmp=cmp, same=same)


def frame_inputs(r: Renderer, cam) -> dict:
    """cam's frame through r's geometry, binning (pairs or scan) and the
    raster kernel, with the raster's arguments and the attribute and
    shade-row tables."""
    kw, sc = r._frame_kwargs, r.scene
    vp, cp = r.frame_uniforms(cam)
    so = geometry.triangle_setup(geometry.transform_corners(sc["corner_world"], vp), None, sc["n_faces"],
                                 kw["width"], kw["height"])
    grid = (so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"])
    bins = geometry.bin_pairs(*grid) if r.binning == "pairs" else geometry.bin_triangles(*grid, kw["bin_capacity"])
    # render_frame's raster arguments, so that plain_raster_memo's key matches the frame's call
    rkw = dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"],
               clear_depth=kw["clear_depth"], tile_row_offset=0)
    args = (so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"])
    corners = (so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"], sc["face_tex"], sc["atlas"])
    return dict(so=so, bins=bins, args=args, rkw=rkw, vis=raster.rasterize_tiles(*args, **rkw), cp=cp,
                attrs=resolve.pack_resolve_attrs(*corners), rows=shade.pack_shade_rows(*corners))


def shade_times(res: dict, texels, texel_format: str, lut, cp, ma: int, light: dict, rows) -> dict:
    """Both shade kernels' stats on shade_pair's inputs: bound (shade_bound),
    ms and device ms beside their plain versions' (timed), error."""
    kw = dict(max_anisotropy=ma, texel_format=texel_format, **light)
    g, fid = res["g"], res["fid"]
    fns = {"gather": (lambda: shade.shade_gbuffer(g, texels, cp, srgb_lut=lut, **kw),
                      lambda: shade.shade_gbuffer_plain(g, texels, cp, **kw)),
           "deferred": (lambda: shade.shade_deferred(fid, rows, texels, cp, srgb_lut=lut, **kw),
                        lambda: shade.shade_deferred_plain(fid, rows, texels, cp, **kw))}
    return {kind: dict(max_abs_err=res["cmp"][kind]["max_abs_err"], library_ms=None,
                       **shade_bound(kind, g, fid, texels, ma), **timed(*fns[kind], 20, 2))
            for kind in SHADE_KERNELS}


def fmt_times(kind: str, st: dict) -> str:
    dev = st["dev_ms"]
    return (f"{kind} {st['ms']:.4f} ms (device {fmt_ms(dev)}) vs plain {st['plain_ms']:.3f} ms (device "
            f"{fmt_ms(st['plain_dev_ms'])}); bound {st['bound_ms']:.4f} ms by {st['bound_by']} ({st['probes']} "
            f"probes reading {st['rows']} distinct atlas rows), {st['bound_ms'] / st['ms']:.3f} of it by events"
            + (f", {st['bound_ms'] / dev:.3f} by device ms" if dev else "") + f"; {fmt_lines(st)}")


def kernel_phases(r: Renderer, cam, card: str, phase: str = "kernel_phases") -> dict:
    """Each kernel against its plain version on frame 0's real inputs, and
    once more into guarded outputs (guard), recorded under ``phase``."""
    kw = r._frame_kwargs
    sc = r.scene
    vp, cp = r.frame_uniforms(cam)
    th, tw, tx, ty = kw["tile_h"], kw["tile_w"], r.tiles_x, r.tiles_y
    clip = geometry.transform_corners(sc["corner_world"], vp)
    so = geometry.triangle_setup(clip, None, sc["n_faces"], kw["width"], kw["height"])
    bins = geometry.bin_pairs(so["aabb"], so["valid"], tx, ty, tw, th)
    rkw = dict(tile_h=th, tile_w=tw, tiles_x=tx, tiles_y=ty, clear_depth=kw["clear_depth"])
    out = {}

    vis = raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **rkw)
    vis_p = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **rkw)
    torch.cuda.synchronize()
    fid_bad = int((vis[1] != vis_p[1]).sum())
    depth_bad = int((vis[0] != vis_p[0]).sum())
    depth_err = float((vis[0] - vis_p[0]).abs().max())
    covered = int((vis[1] >= 0).sum())
    work = raster_work(so, bins, th, tw, tx)
    hp, wp = vis.shape[1:]
    out["raster"] = dict(
        max_abs_err=depth_err, library_ms=None, pairs=work["pairs"], densest=work["densest"],
        **raster_bound(work, tx * ty, hp, wp),
        **timed(
            lambda: raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **rkw),
            lambda: raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **rkw),
            20, 2,
        ),
    )
    st = out["raster"]
    print(f"raster: pairs {work['pairs']} of {work['faces']} faces (per tile mean {work['pairs'] / (tx * ty):.0f}, "
          f"densest tile "
          f"{work['densest']}), work units {work['units']}, evaluated (pair, pixel) {work['evals']}, "
          f"covered px {covered}; vs plain: "
          f"face id differs at {fid_bad} px, depth at {depth_bad} px, max abs diff {depth_err}; "
          f"{st['ms']:.4f} ms (device {fmt_ms(st['dev_ms'])}) vs plain {st['plain_ms']:.3f} ms; bound "
          f"{st['bound_ms']:.4f} ms by {st['bound_by']}, {st['bound_ms'] / st['ms']:.4f} of it")
    ops = device_ops(lambda: raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                                    **rkw), 20)
    print("raster device ms by operation: " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in ops.items()))
    check(fid_bad == 0 and depth_bad == 0, "raster kernel disagrees with its plain version")
    guard_raster(phase, so, bins, vis, **rkw)

    attrs = resolve.pack_resolve_attrs(
        so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"], sc["face_tex"], sc["atlas"]
    )
    ma = kw["max_anisotropy"]
    g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma)
    g_p = resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=ma)
    torch.cuda.synchronize()
    flip = (g[19] != g_p[19]) & (vis[1] >= 0)
    n_flip = int(flip.sum())
    keep = ~flip
    int_bad = int(sum(((g[i] != g_p[i]) & keep).sum() for i in resolve.INT_PLANES))
    gf, gpf = g[FLOAT_PLANES][:, keep], g_p[FLOAT_PLANES][:, keep]
    float_bad = int((~torch.isclose(gf, gpf, rtol=1e-5, atol=1e-6)).sum())
    res_err = float((gf - gpf).abs().max())
    fid = vis[1][vis[1] >= 0].long()
    out["resolve"] = dict(
        max_abs_err=res_err, library_ms=None,
        # vis read, the attribute rows of the visible faces, the G-buffer written;
        # ~150 flops per covered pixel (csrc/resolve.cu).
        **bound(2 * hp * wp * 4 + int(torch.unique(fid).numel()) * attrs.shape[1] * 4 + g.numel() * 4,
                covered * 150),
        **timed(
            lambda: resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma),
            lambda: resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=ma),
            20, 3,
        ),
    )
    print(f"resolve: vs plain: l0 flips at {n_flip} px ({n_flip / max(covered, 1):.2e} of covered), "
          f"integer-plane values differing {int_bad}, float-plane values outside rtol 1e-5/atol 1e-6 "
          f"{float_bad}, max abs diff {res_err}; "
          f"{out['resolve']['ms']:.3f} ms vs plain {out['resolve']['plain_ms']:.3f} ms")
    check(n_flip <= 0.001 * covered and int_bad == 0 and float_bad == 0,
          "resolve kernel disagrees with its plain version")
    guard_resolve(phase, vis, attrs, g, max_anisotropy=ma)

    tiles = dict(tiles_x=tx, tiles_y=ty, tile_h=th, tile_w=tw)
    plan = sampler.plan_tiles(g, max_anisotropy=ma, **tiles)
    plan_p = sampler.plan_tiles_plain(g, max_anisotropy=ma, **tiles)
    torch.cuda.synchronize()
    table_bad = int((plan["table"] != plan_p["table"]).sum())
    assign_bad = int((plan["assign"] != plan_p["assign"]).sum())
    n_matched = int((g[16] > 0).sum())
    plan_out_bytes = plan["table"].numel() * 4 + plan["assign"].numel() * 4
    plan_bound_all = bound(g.numel() * 4 + plan_out_bytes, hp * wp * 100)  # counted with all 24 planes
    plan_bound_planes = bound(PLAN_PLANES * hp * wp * 4 + plan_out_bytes, hp * wp * 100)
    out["plan"] = dict(
        max_abs_err=float((plan["assign"] - plan_p["assign"]).abs().max()), library_ms=None,
        **plan_bound(hp, wp, n_matched, plan),
        **timed(
            lambda: sampler.plan_tiles(g, max_anisotropy=ma, **tiles),
            lambda: sampler.plan_tiles_plain(g, max_anisotropy=ma, **tiles),
            20, 3,
        ),
    )
    cls = plan["cls"]
    n_used = plan["n_used"][cls == sampler.CLS_WINDOWED].float()
    st = out["plan"]
    print(f"plan: tiles windowed {int((cls == sampler.CLS_WINDOWED).sum())}, residual "
          f"{int((cls == sampler.CLS_RESIDUAL).sum())} ({int(plan['residual_px'])} px), empty "
          f"{int((cls == sampler.CLS_EMPTY).sum())}; windows per windowed tile mean {float(n_used.mean()):.2f} "
          f"max {int(n_used.max())}; vs plain: table words differing {table_bad}, assignments differing "
          f"{assign_bad}; {st['ms']:.4f} ms (device {fmt_ms(st['dev_ms'])}) vs plain {st['plain_ms']:.3f} ms; "
          f"bound {st['bound_ms']:.4f} ms by {st['bound_by']} (plane 16 everywhere, {PLAN_PLANES - 1} planes at "
          f"the {n_matched} matched px; {PLAN_PLANES} planes at every px: {plan_bound_planes['bound_ms']:.4f} ms; "
          f"all 24, as counted before: {plan_bound_all['bound_ms']:.4f} ms)")
    ops = device_ops(lambda: sampler.plan_tiles(g, max_anisotropy=ma, **tiles), 20)
    print("plan device ms by operation: " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in ops.items()))
    # The kernel's floor: every tile empty (one barrier, then the table and
    # assignment writes), against this frame's covered tiles.
    g_empty = g.clone()
    g_empty[16] = 0.0
    empty_ms = device_ms(lambda: sampler.plan_tiles(g_empty, max_anisotropy=ma, **tiles), 20)
    del g_empty
    print(f"plan on the same G-buffer with no pixel matched (all {tx * ty} tiles empty): device {fmt_ms(empty_ms)} ms")
    hist = torch.bincount(plan["n_used"][cls != sampler.CLS_EMPTY].long(), minlength=sampler.K2 + 1).tolist()
    print("plan: covered tiles by windows used (0..32): " + " ".join(str(n) for n in hist))
    check(table_bad == 0 and assign_bad == 0, "plan kernel disagrees with its plain version")
    guard_plan(phase, g, plan, max_anisotropy=ma, **tiles)

    skw = sample_kwargs(kw, tiles)
    page = sc["atlas"]["page"]
    probe_map = torch.where(g[16] > 0, shade.probe_count(g[17], g[14], g[15], g[9], g[10], ma), 0.0)
    n_probe = probe_map[g[16] > 0]
    fb = sampler.sample_tiles(g, page, plan, cp, **skw)
    fb_p = sampler.sample_tiles_plain(g, page, plan, cp, **skw)
    w, h = kw["width"], kw["height"]
    enc_diff = (present.encode_srgb_u8(fb, w, h).int() - present.encode_srgb_u8(fb_p, w, h).int()).abs()
    lsb = int(enc_diff.max())
    px_bad = int((enc_diff.amax(dim=0) > 0).sum())
    smp_err = float((fb - fb_p).abs().max())
    sample_flops = float(n_probe.sum()) * 100
    # Counted as before: all 24 planes, the assignment and table, no texels.
    sample_bound_all = bound((g.numel() + plan["assign"].numel() + plan["table"].numel()) * 4 + fb.numel() * 4,
                             sample_flops)
    texel_bytes = touched_page_bytes(g, page, ma)
    sample_bound_planes = bound(SAMPLE_PLANES * hp * wp * 4 + tx * ty * 4 + texel_bytes + fb.numel() * 4,
                                sample_flops)
    out["sample"] = dict(
        max_abs_err=smp_err, library_ms=None,
        # What this frame needs: the match plane at every pixel, the other
        # SAMPLE_PLANES - 1 planes at the matched pixels, each tile's class,
        # every distinct page texel the probes touch read once (8 bytes),
        # the framebuffer written; per probe 2 mips x 4 texels x 4 channels
        # of multiply-adds plus the weights, ~100 flops.
        **bound(hp * wp * 4 + (SAMPLE_PLANES - 1) * n_matched * 4 + tx * ty * 4 + texel_bytes + fb.numel() * 4,
                sample_flops),
        **timed(
            lambda: sampler.sample_tiles(g, page, plan, cp, **skw),
            lambda: sampler.sample_tiles_plain(g, page, plan, cp, **skw),
            20, 3,
        ),
    )
    st = out["sample"]
    print(f"sample: probes per covered px mean {float(n_probe.mean()):.2f} max {float(n_probe.max()):.0f}, "
          f"mip levels in view {sorted(int(x) for x in torch.unique(g[19][g[16] > 0]).tolist())}; "
          f"vs plain: {px_bad} px differ after the u8 encode, max {lsb} LSB, linear max abs diff {smp_err}; "
          f"{st['ms']:.4f} ms (device {fmt_ms(st['dev_ms'])}) vs plain {st['plain_ms']:.3f} ms; bound "
          f"{st['bound_ms']:.4f} ms by {st['bound_by']} (plane 16 everywhere, {SAMPLE_PLANES - 1} planes at the "
          f"{n_matched} matched px, {texel_bytes} B of distinct page texels of a {page.numel() * 2} B page; "
          f"{SAMPLE_PLANES} planes at every px: {sample_bound_planes['bound_ms']:.4f} ms; all 24 and the plan, no "
          f"texels, as counted before: {sample_bound_all['bound_ms']:.4f} ms)")
    check(lsb <= 1, "sample kernel disagrees with its plain version")
    guard_sample(phase, g, page, plan, cp, fb, **skw)
    print_guards(phase, card)
    # A warp runs as many probe rounds as its worst lane needs.
    for ww, wh in ((32, 1), (8, 4)):
        worst = probe_map.reshape(hp // wh, wh, wp // ww, ww).amax(dim=(1, 3))
        worst = worst[worst > 0]
        print(f"sample: probes per warp of {ww}x{wh} px (worst lane), mean over the {worst.numel()} warps with a "
              f"covered px {float(worst.mean()):.2f}, {float(worst.mean()) / float(n_probe.mean()):.2f} of the mean "
              f"per covered px")

    # The frame does not depend on the plan: with every windowed tile marked
    # residual the kernel must give the same frame bit for bit.
    table = plan["table"].clone()
    table[:, 0, 0] = torch.where(table[:, 0, 0] == sampler.CLS_WINDOWED, sampler.CLS_RESIDUAL, table[:, 0, 0])
    forced = dict(plan, table=table)
    fb_r = sampler.sample_tiles(g, page, forced, cp, **skw)
    same = bool(torch.equal(fb_r, fb))
    direct_ms = cuda_ms(lambda: sampler.sample_tiles(g, page, forced, cp, **skw), 20)
    print(f"sample under an all-residual plan: frame equal to the one under the real plan {same}; "
          f"{direct_ms:.4f} ms vs {st['ms']:.4f} ms")
    check(same, "the sampled frame depends on the plan")
    return out


def print_shade_info() -> None:
    """Registers, resident blocks per SM, threads and static shared memory
    per block of each shade kernel instance (one per row format)."""
    for name in ("shade_gbuffer", "shade_deferred"):
        for dtype, code in zip(SHADE_DTYPES, (0, 1, 2, 3)):
            regs, blocks, threads, smem = _build.kernel_info(name, code)
            print(f"{name} kernel, {dtype} rows: {regs} registers per thread, {blocks} resident blocks per SM of "
                  f"{threads} threads ({blocks * threads // 32} warps), {smem} B of static shared memory per block")


def shade_kernels(scene, r: Renderer, cam, card: str, phase: str = "shade_kernels") -> dict:
    """Phase 1c: the gather and deferred kernels (csrc/shade.cu) on frame
    0's real inputs at 1920x1080 against their plain versions (shade_pair)
    with the atlas rows in each texel dtype at max_anisotropy 16, float16
    at 1 too, and on the middle slab (the second of SLAB_SPLIT, float16):
    the slab's frames equal the whole frame's rows bit for bit. Each
    configuration's ms, device ms and bound beside the plain versions';
    the kernels' registers and blocks per SM. Returns the stats at the
    gather path's rows (float16) and r's anisotropy."""
    kw = r._frame_kwargs
    ma_main = kw["max_anisotropy"]
    light = light_kwargs(kw)
    f = frame_inputs(r, cam)
    vis, cp, attrs, rows = f["vis"], f["cp"], f["attrs"], f["rows"]
    print_shade_info()
    out = {}
    full16 = None
    for dtype in SHADE_DTYPES:
        t0 = time.perf_counter()
        texels = texels_tensor(scene.atlas.texels, dtype, vis.device)
        torch.cuda.synchronize()
        up_s = time.perf_counter() - t0
        fmt = "srgb8" if dtype == "srgb8" else "float"
        lut = shade.srgb_table(vis.device) if dtype == "srgb8" else None  # as the scene upload makes it
        for ma in (ma_main, 1) if dtype == "float16" else (ma_main,):
            res = shade_pair(phase, vis, attrs, rows, texels, fmt, lut, cp, ma, light)
            times = shade_times(res, texels, fmt, lut, cp, ma, light, rows)
            print(f"shade kernels, {dtype} rows {tuple(texels.shape)} ({texels.numel() * texels.element_size()} B, "
                  f"uploaded in {up_s:.2f} s), anisotropy {ma}: " + "; ".join(
                      f"{k} vs plain: {fmt_compare(c)}" for k, c in res["cmp"].items())
                  + f"; deferred equal to gather on the resolve kernel's G-buffer {res['same']}; "
                  + "; ".join(fmt_times(k, times[k]) for k in SHADE_KERNELS) + f" [{card}]")
            if dtype == "float16" and ma == ma_main:
                out, full16 = times, res
        if dtype == "float16":
            th = kw["tile_h"]
            per = -(-r.tiles_y // SLAB_SPLIT)  # tile rows per slab, padded as parallel.py pads them
            so = f["so"]
            sbins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, per, kw["tile_w"], th, ty_base=per)
            svis = raster.rasterize_tiles(so["setup"], so["aabb"], sbins["pair_faces"], sbins["offsets"], tile_h=th,
                                          tile_w=kw["tile_w"], tiles_x=r.tiles_x, tiles_y=per,
                                          clear_depth=kw["clear_depth"], tile_row_offset=per)
            res = shade_pair(phase, svis, attrs, rows, texels, fmt, lut, cp, ma_main, light, tile_row_offset=per,
                             tile_h=th)
            px = slice(per * th, 2 * per * th)
            same = {k: bool(torch.equal(res[k], full16[k][:, px])) for k in SHADE_KERNELS}
            print(f"shade kernels, middle slab (tile rows {per}-{2 * per - 1}, y_offset {per * th}), float16: "
                  + "; ".join(f"{k} vs plain: {fmt_compare(c)}" for k, c in res["cmp"].items())
                  + f"; equal to the whole frame's rows {same}; deferred "
                  + fmt_lines(shade_warp_lines("deferred", res["g"], res["fid"], texels, ma_main)) + f" [{card}]")
            check(all(same.values()), f"{phase}: a slab's shaded rows differ from the frame's")
        del texels
        torch.cuda.empty_cache()
    print_guards(phase, card)
    return out


# config_matrix's configurations: (label, RendererConfig fields, output,
# scene). The tile shapes the reference takes past the default 32x128
# (8-row chunks at 8 and 40 rows, 8,192 px at 64x128 and 32x256, 7 chunks
# at 112x128, a tile wider than 1024 px, and one of at least 100k px), the
# options the card had not run, gather on the float32 and bfloat16 atlas
# rows, scan binning and deferred shading at 64x128. "small" is the small
# orbit scene (MATRIX_SMALL_SCENE), where the plain raster's pairs x tile
# pixels stay small at the widest tiles.
MATRIX = (
    ("8x128", dict(tile_h=8), "srgb_u8", "orbit"),
    ("40x128", dict(tile_h=40), "srgb_u8", "orbit"),
    ("16x256", dict(tile_h=16, tile_w=256), "srgb_u8", "orbit"),
    ("64x128", dict(tile_h=64), "srgb_u8", "orbit"),
    ("32x256", dict(tile_w=256), "srgb_u8", "orbit"),
    ("112x128", dict(tile_h=112), "srgb_u8", "orbit"),
    ("16x1024", dict(tile_h=16, tile_w=1024), "srgb_u8", "orbit"),
    ("112x896", dict(tile_h=112, tile_w=896), "srgb_u8", "orbit"),
    ("112x1920 small", dict(tile_h=112, tile_w=1920), "srgb_u8", "small"),
    ("112x3840 small", dict(tile_h=112, tile_w=3840), "srgb_u8", "small"),
    ("anisotropy 1", dict(max_anisotropy=1), "srgb_u8", "orbit"),
    ("anisotropy 2", dict(max_anisotropy=2), "srgb_u8", "orbit"),
    ("anisotropy 4", dict(max_anisotropy=4), "srgb_u8", "orbit"),
    ("anisotropy 8", dict(max_anisotropy=8), "srgb_u8", "orbit"),
    ("opaque", dict(blend="opaque"), "srgb_u8", "orbit"),
    ("linear", {}, "linear", "orbit"),
    ("gbuf", {}, "gbuf", "orbit"),
    ("gather float32", dict(sampler="gather", texture_dtype="float32"), "srgb_u8", "orbit"),
    ("gather bfloat16", dict(sampler="gather", texture_dtype="bfloat16"), "srgb_u8", "orbit"),
    ("scan 64x128", dict(binning="scan", tile_h=64), "srgb_u8", "orbit"),
    ("gather 64x128", dict(sampler="gather", tile_h=64), "srgb_u8", "orbit"),
    ("deferred 64x128", dict(shading="deferred", tile_h=64), "srgb_u8", "orbit"),
)
MATRIX_SMALL_SCENE = dict(floor_quads=32, spheres=2, rings=12, segments=12, tex_size=64, n_textures=2)
MATRIX_REPLAYS = 5
MATRIX_SLABS = {"64x128": 2, "112x128": 2}  # configurations also rendered as slabs, and how many
# Tile shapes past 4096 px in the sanitizer's case set (sanitize_cases).
SANITIZE_TILES = ((64, 128), (16, 1024))
MATRIX_BENCH_FRAMES = 16


@contextlib.contextmanager
def plain_raster_memo():
    """Within the context raster.rasterize_tiles_plain, called again with
    inputs equal (torch.equal, same keyword arguments) to its last call's,
    returns a copy of that call's result instead of evaluating again:
    config_matrix's kernel check and its eager plain frame raster the same
    pairs, and the plain raster costs pairs x tile pixels (2 x 1.9e10
    evaluations at 112x896)."""
    plain = raster.rasterize_tiles_plain
    last = {}

    def cached(*args, **kw):
        hit = last.get("args")
        if (hit is not None and last["kw"] == kw and len(hit) == len(args)
                and all(a.shape == b.shape and bool(torch.equal(a, b)) for a, b in zip(hit, args))):
            return last["out"].clone()
        out = plain(*args, **kw)
        last.update(args=args, kw=kw, out=out.clone())
        return out

    raster.rasterize_tiles_plain = cached
    try:
        yield
    finally:
        raster.rasterize_tiles_plain = plain


def matrix_device_ms(fns: dict, reps: int = 5) -> dict:
    """Device ms per call of each kernel wrapper in fns ({name: fn}), from
    one torch.profiler session: each operation's mean recorded time once
    per launch a call makes (microbench.device_ms's rule), attributed by
    the CUDA kernel's name; the raster's key-buffer memset and the plan's
    zero fill count with their kernels."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    owner = {"raster": ("raster", "Memset"), "resolve": ("resolve_kernel",), "plan": ("plan_kernel", "Fill"),
             "sample": ("sample_kernel",), "gather": ("shade_gbuffer_kernel",), "deferred": ("shade_deferred_kernel",)}
    out = {name: 0.0 for name in fns}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        for name in fns:
            if any(k in e.key for k in owner[name]):
                out[name] += e.self_device_time_total / e.count * -(-e.count // reps) / 1e3
                break
    return {k: (v if v > 0 else None) for k, v in out.items()}


def matrix_kernels(r: Renderer, cam, phase: str) -> dict:
    """Each render kernel of r's path against its plain version on cam's
    frame inputs (raster and plan exact, resolve's integer planes exact and
    its float planes kernel_phases' rule, sample within 1 LSB, the shade
    kernels by shade_pair) and once more into guarded outputs (guard), with
    its device ms."""
    kw = r._frame_kwargs
    sc = r.scene
    fi = frame_inputs(r, cam)
    so, bins, args, rkw, vis, cp, attrs = (fi[k] for k in ("so", "bins", "args", "rkw", "vis", "cp", "attrs"))
    th, tw, tx, ty = kw["tile_h"], kw["tile_w"], r.tiles_x, r.tiles_y
    tiles = dict(tiles_x=tx, tiles_y=ty, tile_h=th, tile_w=tw)
    res, fns = {}, {}
    vis_p = raster.rasterize_tiles_plain(*args, **rkw)
    hp, wp = vis.shape[1:]
    work = raster_work(so, bins, th, tw, tx)
    bounds = {"raster": raster_bound(work, tx * ty, hp, wp)}
    res["raster"] = (f"{'exact' if torch.equal(vis, vis_p) else 'DIFFERS'}, {work['units']} units, "
                     f"{work['evals']} evaluations")
    check(torch.equal(vis, vis_p), f"{phase}: raster kernel disagrees with its plain version")
    guard_raster(phase, so, bins, vis, **rkw)
    fns["raster"] = lambda: raster.rasterize_tiles(*args, **rkw)
    if kw["shading"] == "forward":
        ma = kw["max_anisotropy"]
        g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma)
        g_p = resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=ma)
        n_flip, int_bad, float_bad = resolve_disagreement(g, g_p, vis[1] >= 0)
        res["resolve"] = f"integer planes {'exact' if int_bad == 0 else f'{int_bad} off'}, float off {float_bad}, " \
                         f"l0 flips {n_flip}"
        check(n_flip <= 0.001 * int((vis[1] >= 0).sum()) and int_bad == 0 and float_bad == 0,
              f"{phase}: resolve kernel disagrees with its plain version")
        guard_resolve(phase, vis, attrs, g, max_anisotropy=ma)
        fns["resolve"] = lambda: resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma)
        if kw["sampler"] == "window" and kw["output"] != "gbuf":
            plan = sampler.plan_tiles(g, max_anisotropy=ma, **tiles)
            plan_p = sampler.plan_tiles_plain(g, max_anisotropy=ma, **tiles)
            same = all(bool(torch.equal(plan[k], plan_p[k])) for k in ("table", "assign", "residual_px"))
            res["plan"] = "exact" if same else "DIFFERS"
            bounds["plan"] = plan_bound(hp, wp, int((g[16] > 0).sum()), plan)
            check(same, f"{phase}: plan kernel disagrees with its plain version")
            guard_plan(phase, g, plan, max_anisotropy=ma, **tiles)
            fns["plan"] = lambda: sampler.plan_tiles(g, max_anisotropy=ma, **tiles)
            skw = sample_kwargs(kw, tiles)
            page = sc["atlas"]["page"]
            fb = sampler.sample_tiles(g, page, plan, cp, **skw)
            fb_p = sampler.sample_tiles_plain(g, page, plan, cp, **skw)
            w, h = kw["width"], kw["height"]
            lsb = int((present.encode_srgb_u8(fb, w, h).int() - present.encode_srgb_u8(fb_p, w, h).int()).abs().max())
            res["sample"] = f"{lsb} LSB"
            check(lsb <= 1, f"{phase}: sample kernel disagrees with its plain version")
            guard_sample(phase, g, page, plan, cp, fb, **skw)
            fns["sample"] = lambda: sampler.sample_tiles(g, page, plan, cp, **skw)
    if path_of(r) != "window" and kw["output"] != "gbuf":
        # The shade kernel of the path (shade_pair runs both on these inputs).
        kind = path_of(r)
        texels, fmt, lut, light = sc["atlas"]["texels"], kw["texture_format"], sc["atlas"].get("srgb_lut"), \
            light_kwargs(kw)
        rows = fi["rows"]
        sp = shade_pair(phase, vis, attrs, rows, texels, fmt, lut, cp, kw["max_anisotropy"], light)
        res[kind] = f"{fmt_compare(sp['cmp'][kind])}, deferred = gather {sp['same']}"
        bounds[kind] = shade_bound(kind, sp["g"], sp["fid"], texels, kw["max_anisotropy"])
        skw = dict(max_anisotropy=kw["max_anisotropy"], texel_format=fmt, srgb_lut=lut, **light)
        fns[kind] = ((lambda: shade.shade_gbuffer(sp["g"], texels, cp, **skw)) if kind == "gather"
                     else (lambda: shade.shade_deferred(sp["fid"], rows, texels, cp, **skw)))
    torch.cuda.synchronize()
    dev = matrix_device_ms(fns)
    return {k: (dev[k], res[k], bounds.get(k)) for k in res}


def matrix_frames_agree(label: str, out: str, got: dict, plain: dict) -> str:
    """The graph frame against the eager plain frame: color within 1 LSB
    (a linear frame after the sRGB encode; a G-buffer by kernel_phases'
    resolve rule, face ids exact), depth and the counters equal."""
    depth_eq = bool(torch.equal(got["depth"], plain["depth"]))
    if out == "gbuf":
        g, g_p = got["gbuf"], plain["gbuf"]
        covered = plain["fid"] >= 0
        n_flip, int_bad, float_bad = resolve_disagreement(g, g_p, covered)
        fid_eq = bool(torch.equal(got["fid"], plain["fid"]))
        check(depth_eq and fid_eq and int_bad == 0 and float_bad == 0 and n_flip <= 0.001 * int(covered.sum()),
              f"config_matrix {label}: G-buffer frame disagrees with the plain versions")
        return (f"G-buffer integer planes {int_bad} off, float planes {float_bad} off, l0 flips {n_flip}, "
                f"face ids equal {fid_eq}, depth equal {depth_eq}")
    c, c_p = got["color"], plain["color"]
    if out == "linear":
        h, w = c.shape[1:]
        lin_err = float((c - c_p).abs().max())
        c, c_p = present.encode_srgb_u8(c, w, h), present.encode_srgb_u8(c_p, w, h)
    diff = (c.int() - c_p.int()).abs()
    lsb, px = int(diff.max()), int((diff.amax(dim=0) > 0).sum())
    counters = all(int(got[k]) == int(plain[k]) for k in ("bin_overflow", "window_miss_px"))
    check(lsb <= 1 and depth_eq and counters, f"config_matrix {label}: frame disagrees with the plain versions")
    return (f"color max {lsb} LSB ({px} px off){f', linear max abs {lin_err:.3g}' if out == 'linear' else ''}, "
            f"depth equal {depth_eq}, bin_overflow {int(got['bin_overflow'])} = {int(plain['bin_overflow'])}, "
            f"window_miss_px {int(got['window_miss_px'])} = {int(plain['window_miss_px'])}")


def config_matrix(scene, cam, card: str, seed: int) -> dict:
    """Every MATRIX configuration through Renderer at 1920x1080 on cam: the
    graph frame (captured by the first render; MATRIX_REPLAYS replays timed by
    events, their median) against the frame rendered eagerly inside
    plain_kernels(), and each render kernel of the path against its plain
    version with a guard band (matrix_kernels); deferred 64x128 equal to
    gather 64x128 bit for bit. One line per configuration with the card's
    name and power limit. Returns {label: line fields}."""
    t0 = time.perf_counter()
    small = None
    out, frames = {}, {}
    for label, fields, output, which in MATRIX:
        t_cfg = time.perf_counter()
        if which == "small" and small is None:
            small = build_orbit_scene(seed=seed, **MATRIX_SMALL_SCENE)
        sc = scene if which == "orbit" else small
        cfg = RendererConfig(width=WIDTH, height=HEIGHT, **fields)
        r = Renderer(sc, cfg, output=output)
        phase = f"config_matrix {label}"
        K.reset_launches()
        got = r.render(cam)
        torch.cuda.synchronize()
        K.reset_launches()
        ms = event_median(lambda: r.render(cam), MATRIX_REPLAYS)
        launches = {k: v // (MATRIX_REPLAYS + 1) for k, v in K.LAUNCHES.items() if v}
        want = path_want(path_of(r), MATRIX_REPLAYS + 1)
        if output == "gbuf":
            want = {k: v if k in ("raster", "resolve") else 0 for k, v in want.items()}
        check(all(K.LAUNCHES[k] == want[k] for k in KERNELS),
              f"{phase}: launches {dict(K.LAUNCHES)} over {MATRIX_REPLAYS + 1} frames, want {want}")
        with plain_raster_memo():
            kernels = matrix_kernels(r, cam, phase)
            with K.plain_kernels():
                plain = r.render(cam)
            torch.cuda.synchronize()
        agree = matrix_frames_agree(label, output, got, plain)
        if label in MATRIX_SLABS:  # parallel.py's slab rows at this tile height
            fn = make_sharded_renderer(r.scene, r.config, MATRIX_SLABS[label], WIDTH, HEIGHT)
            uniforms = r.frame_uniforms(cam)
            fn(r.scene, *uniforms)
            slabs = fn(r.scene, *uniforms)
            same = all(bool(torch.equal(slabs[k], got[k])) for k in GRAPH_OUTPUTS)
            fn.close()
            check(same, f"{phase}: the {MATRIX_SLABS[label]}-slab frame differs from the frame")
            agree += f"; {MATRIX_SLABS[label]}-slab graph frame equal to it {same}"
        if label.startswith(("gather 64x128", "deferred 64x128")):
            frames[label.split()[0]] = got
        print_guards(phase, card)
        intact = all(g["intact"] and g["same"] for p, _, g in GUARDS if p == phase)
        check(intact, f"{phase}: a guard band was touched")
        kern = "; ".join(f"{k} device {fmt_ms(v[0])} ms"
                         + (f" (bound {v[2]['bound_ms']:.4f} ms by {v[2]['bound_by']})" if v[2] else "") + f" {v[1]}"
                         + (f", {fmt_lines(v[2])}" if k in SHADE_KERNELS else "")
                         for k, v in kernels.items())
        print(f"config_matrix {label}: {WIDTH}x{HEIGHT} tile {cfg.tile_h}x{cfg.tile_w} ({r.tiles_x}x{r.tiles_y} tiles), "
              f"sampler {r.sampler}, binning {r.binning}, shading {cfg.shading}, output {output}, anisotropy "
              f"{cfg.max_anisotropy}, blend {cfg.blend}, texels {r.texture_dtype if r.sampler == 'gather' else '-'}; "
              f"graph frame median {ms:.4f} ms over {MATRIX_REPLAYS} replays, launches per replay {launches}; vs eager "
              f"plain frame: {agree}; kernels vs plain: {kern}; guard bands intact {intact}; "
              f"{time.perf_counter() - t_cfg:.1f} s [{card}]")
        out[label] = dict(ms=ms, launches=launches, kernels={k: v[0] for k, v in kernels.items()})
        del r, got, plain
    same = all(bool(torch.equal(frames["gather"][k], frames["deferred"][k])) for k in GRAPH_OUTPUTS)
    print(f"config_matrix: deferred 64x128 equal to forward + gather 64x128 bit for bit ({', '.join(GRAPH_OUTPUTS)}): "
          f"{same} [{card}]")
    check(same, "config_matrix: deferred 64x128 differs from gather 64x128")
    # The bench at the tallest tile the reference takes, as a user calls it.
    argv = ["--scene", "orbit", "--tile-h", "112", "--tile-w", "128", "--frames", str(MATRIX_BENCH_FRAMES),
            "--warmup", "2", "--seed", str(seed)]
    K.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    print(f"config_matrix: python -m tpurast_torch.cli {' '.join(argv)} -> exit {rc}, launches {dict(K.LAUNCHES)}")
    check(rc == 0 and len(lines) == 1, f"config_matrix: the bench at 112x128 exited {rc} with {len(lines)} lines")
    print(lines[0])
    res = json.loads(lines[0])
    check(res["parity_max_lsb"] is not None and res["parity_max_lsb"] <= 1 and res["dropped_pairs"] == 0,
          "config_matrix: the bench at 112x128 failed its parity gate or dropped pairs")
    check(all(K.LAUNCHES[k] > 0 for k in RENDER_KERNELS), "config_matrix: the bench at 112x128 skipped a kernel")
    print(f"config_matrix: {len(MATRIX)} configurations and the bench in {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def sample_kwargs(kw: dict, tiles: dict) -> dict:
    """sample_tiles' keyword arguments from a Renderer's frame arguments."""
    return dict(max_anisotropy=kw["max_anisotropy"], light_direction=kw["light_direction"],
                light_color=kw["light_color"], ambient_amount=kw["ambient_amount"],
                specular_power=kw["specular_power"], clear_color=kw["clear_color"], blend=kw["blend"], **tiles)


def touched_page_bytes(g, page, ma) -> int:
    """Bytes of the distinct page texels (4 bf16 channels each) that the
    matched pixels' probes touch, own and parent mip, from the plain
    version's tap positions."""
    gm = g[:, g[16] > 0]
    n_px = shade.probe_count(gm[17], gm[14], gm[15], gm[9], gm[10], ma)
    touched = torch.zeros(page.shape[1:], dtype=torch.bool, device=g.device)
    for i in range(int(n_px.max()) if n_px.numel() else 0):
        live = i < n_px
        for ww, hh, by, bx in ((9, 10, 20, 21), (11, 12, 22, 23)):
            py, px, _, _ = sampler.tap_position(i, gm[6], gm[7], gm[14], gm[15], gm[17], n_px, gm[ww], gm[hh],
                                                gm[by], gm[bx])
            py, px = py[live], px[live]
            for dy in (0, 1):
                for dx in (0, 1):
                    touched[py + dy, px + dx] = True
    return int(touched.sum()) * 8


def probe_phases(dev, card: str) -> dict:
    """vmem_take and the three plane_scale geometries against their plain
    versions at the tools' sizes (tools/microbench.py cmd_vmemtake,
    tools/microbench_pipeline.py main): bit for bit; each shape once more
    into guarded outputs (guard)."""
    out = {}
    n = microbench.N_PX
    table = torch.rand((4096, 16), generator=microbench.generator(dev, 1), device=dev)
    idx = microbench.randint(4096, n, dev, 0)
    got, want = probes.vmem_take(table, idx), probes.vmem_take_plain(table, idx)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    out["vmem_take"] = dict(
        max_abs_err=float((got - want).abs().max()), library_ms=None,  # table.sum(1)[idx] is two calls
        **bound(table.numel() * 4 + idx.numel() * 4 + n * 4, n * 15),
        **timed(
            lambda: probes.vmem_take(table, idx),
            lambda: probes.vmem_take_plain(table, idx),
            20, 5,
        ),
    )
    print(f"vmem_take: {n} indices into a 4096x16 f32 table; vs plain: {bad} sums differ, max abs diff "
          f"{out['vmem_take']['max_abs_err']}; {out['vmem_take']['ms']:.4f} ms vs plain "
          f"{out['vmem_take']['plain_ms']:.4f} ms")
    check(bad == 0, "vmem_take kernel disagrees with its plain version")
    guard("probe_phases", "vmem_take", "tr_vmem_take", table, table.shape[0], idx, idx.numel(), Out(got.shape),
          want=(got,))
    # Shapes that stress the design: an odd row count, a count of indices
    # that fills no whole warp or block, rows outside the table (clamped),
    # an index array that starts off the 16-byte grid, one row.
    for rows, n_idx, off in ((4095, n, 0), (4096, 1_000_003, 0), (4096, 1_000_003, 1), (7, 33, 0), (1, 5, 0)):
        tab = torch.rand((rows, 16), generator=microbench.generator(dev, 3), device=dev)
        wild = torch.randint(-3, rows + 3, (n_idx + off,), generator=microbench.generator(dev, 4), device=dev,
                             dtype=torch.int32)[off:]
        got = probes.vmem_take(tab, wild)
        same = bool(torch.equal(got, probes.vmem_take_plain(tab, wild)))
        print(f"vmem_take {rows} rows, {n_idx} indices in [-3, {rows + 3}), array offset {off}: equal to plain {same}")
        check(same, f"vmem_take disagrees with its plain version at {rows} rows, {n_idx} indices")
        guard("probe_phases", f"vmem_take {rows}x{n_idx}+{off}", "tr_vmem_take", tab, rows, wild, n_idx,
              Out(got.shape), want=(got,))

    gbuf = torch.rand((24, 1088, 1920), generator=microbench.generator(dev, 0), device=dev)
    one = gbuf[16:17].clone()
    geoms = {
        "tile-grid (24-plane buffer, 32x128 blocks)": (gbuf, 16, 32, 128),
        "one-plane (1-plane buffer, 32x128 blocks)": (one, 0, 32, 128),
        "row-band (24-plane buffer, 32x1920 blocks)": (gbuf, 16, 32, 1920),
    }
    rows = []
    for label, (src, plane, bh, bw) in geoms.items():
        got = probes.plane_scale(src, plane, block_h=bh, block_w=bw)
        want = probes.plane_scale_plain(src, plane, block_h=bh, block_w=bw)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        # The one-call yardstick, timed like the kernel (50 repeated calls,
        # so its 16.7 MB come from L2 after the first).
        lib = lambda: torch.mul(src[plane], 2)  # noqa: E731
        rows.append(dict(
            max_abs_err=float((got - want).abs().max()),
            library_ms=cuda_ms(lib, 50), library_dev_ms=device_ms(lib, 50),
            **bound(8 * src.shape[1] * src.shape[2], src.shape[1] * src.shape[2]),
            **timed(
                lambda: probes.plane_scale(src, plane, block_h=bh, block_w=bw),
                lambda: probes.plane_scale_plain(src, plane, block_h=bh, block_w=bw),
                50, 50,
            ),
        ))
        r = rows[-1]
        print(f"plane_scale {label}: equal to plain {same}; {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms "
              f"vs torch.mul {r['library_ms']:.4f} ms; device {fmt_ms(r['dev_ms'])} ms vs plain "
              f"{fmt_ms(r['plain_dev_ms'])} ms vs torch.mul {fmt_ms(r['library_dev_ms'])} ms; bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
        check(same, f"plane_scale {label} disagrees with its plain version")
        guard("probe_phases", f"plane_scale {label.split()[0]}", "tr_plane_scale", src, plane, src.shape[1],
              src.shape[2], bh, bw, 0, Out(got.shape), want=(got,))
    # Rectangles whose rows leave the 16-byte grid take the kernel's scalar
    # head and tail (odd width, blocks narrower than 4, a plane offset of 1
    # mod 4 floats): held to the plain version too, small and untimed.
    off_grid = [((3, 67, 381), 1, 32, 128), ((3, 67, 381), 2, 7, 3), ((3, 15, 23), 1, 5, 2)]
    for k, (shape, plane, bh, bw) in enumerate(off_grid):
        src = torch.rand(shape, generator=microbench.generator(dev, 2 + k), device=dev)
        got = probes.plane_scale(src, plane, block_h=bh, block_w=bw)
        same = bool(torch.equal(got, probes.plane_scale_plain(src, plane, block_h=bh, block_w=bw)))
        print(f"plane_scale off the 16-byte grid, {shape} plane {plane}, {bh}x{bw} blocks: equal to plain {same}")
        check(same, f"plane_scale {shape} {bh}x{bw} disagrees with its plain version")
        guard("probe_phases", f"plane_scale {shape} {bh}x{bw}", "tr_plane_scale", src, plane, shape[1], shape[2], bh,
              bw, 0, Out(got.shape), want=(got,))
    out["plane_scale"] = dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))
    print_guards("probe_phases", card)
    return out


def frame_stages(r: Renderer, vp, cp):
    """One frame of r's configured path, stage by stage (the stages of
    render_frame): yields each stage's name once its work is enqueued."""
    kw = r._frame_kwargs
    sc = r.scene
    ma = kw["max_anisotropy"]
    tiles = dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"])
    light = dict(light_direction=kw["light_direction"], light_color=kw["light_color"],
                 ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
                 clear_color=kw["clear_color"], blend=kw["blend"])
    clip = geometry.transform_corners(sc["corner_world"], vp)
    so = geometry.triangle_setup(clip, None, sc["n_faces"], kw["width"], kw["height"])
    yield "geometry"
    bins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"])
    yield "binning"
    vis = raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                 clear_depth=kw["clear_depth"], **tiles)
    yield "raster"
    corners = (so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"], sc["face_tex"], sc["atlas"])
    if kw["shading"] == "forward":
        attrs = resolve.pack_resolve_attrs(*corners)
        yield "pack_attrs"
        g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma)
        yield "resolve"
        if kw["sampler"] == "window":
            plan = sampler.plan_tiles(g, max_anisotropy=ma, **tiles)
            yield "plan"
            fb = sampler.sample_tiles(g, sc["atlas"]["page"], plan, cp, max_anisotropy=ma, **light, **tiles)
            yield "sample"
        else:
            fb = shade.shade_gbuffer(g, sc["atlas"]["texels"], cp, max_anisotropy=ma,
                                     texel_format=kw["texture_format"], srgb_lut=sc["atlas"].get("srgb_lut"), **light)
            yield "shade_gbuffer"
    else:
        rows = shade.pack_shade_rows(*corners)
        yield "pack_shade_rows"
        fb = shade.shade_deferred(vis[1].to(torch.int32), rows, sc["atlas"]["texels"], cp, max_anisotropy=ma,
                                  texel_format=kw["texture_format"], srgb_lut=sc["atlas"].get("srgb_lut"), **light)
        yield "shade_deferred"
    present.encode_srgb_u8(fb, kw["width"], kw["height"])
    yield "encode"


def stage_breakdown(r: Renderer, cam, reps: int = 5) -> dict:
    """Milliseconds per stage of one frame on r's path (CUDA events
    between the stages, median over reps frames after one more)."""
    vp, cp = r.frame_uniforms(cam)
    rows, names = [], []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()
        names = []
        for name in frame_stages(r, vp, cp):
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
            names.append(name)
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
    med = np.median(np.array(rows[1:]), axis=0)
    return {n: float(m) for n, m in zip(names, med)}


def stage_device_ops(r: Renderer, cam) -> dict:
    """Per stage of one frame on r's path: the device operations (kernels,
    copies, memsets) torch.profiler counts and their device milliseconds.
    One profile per stage, each closed after a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    vp, cp = r.frame_uniforms(cam)
    stages = frame_stages(r, vp, cp)
    out = {}
    while True:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            name = next(stages, None)
            torch.cuda.synchronize()
        if name is None:
            return out
        ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        out[name] = dict(ops=sum(e.count for e in ops), dev_ms=sum(e.self_device_time_total for e in ops) / 1e3)


def print_stage_ops(label: str, stages: dict, ops: dict) -> None:
    print(f"{label} per stage, device operations launched / their device ms / stage ms by events: "
          + ", ".join(f"{k} {ops[k]['ops']} / {ops[k]['dev_ms']:.3f} / {v:.3f}" for k, v in stages.items())
          + f"; sum {sum(o['ops'] for o in ops.values())} / {sum(o['dev_ms'] for o in ops.values()):.3f} / "
          f"{sum(stages.values()):.3f}")


def print_stages(label: str, stages: dict, reps: int = 5) -> None:
    print(f"{label} stage ms (frame 0, median of {reps}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"; sum {sum(stages.values()):.3f}")


def run_track(r: Renderer, cams) -> tuple[list, list]:
    """A warm-up frame on cams[0], then one frame per camera; returns the
    frames and their CUDA-event milliseconds."""
    r.render(cams[0])
    torch.cuda.synchronize()
    frames, times = [], []
    for cam in cams:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = r.render(cam)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        frames.append(res)
    return frames, times


def check_frames(frames, label: str) -> None:
    for k, res in enumerate(frames):
        color, depth = res["color"], res["depth"]
        check(tuple(color.shape) == (4, HEIGHT, WIDTH) and color.dtype == torch.uint8, f"{label}: color shape")
        check(tuple(depth.shape) == (HEIGHT, WIDTH), f"{label}: depth shape")
        check(bool(torch.isfinite(depth).all()), f"{label}: non-finite depth")
        check(int(res["bin_overflow"]) == 0, f"{label} frame {k}: bin_overflow {int(res['bin_overflow'])}")
        cov = float((depth > 0).float().mean())
        check(0.05 <= cov <= 0.95, f"{label} frame {k}: coverage {cov:.3f} outside [0.05, 0.95]")


def print_times(label: str, times, r: Renderer, cam) -> None:
    """Frame times, and the device's busy time per frame of cam (kernel
    time by torch.profiler, mean of 3 frames) with the idle share it
    leaves of the median frame."""
    med = float(np.median(times))
    busy = device_ms(lambda: r.render(cam), 3)
    idle = "not measured" if busy is None else f"{1.0 - busy / med:.3f}"
    print(f"{label} frame ms: " + ", ".join(f"{t:.2f}" for t in times)
          + f" (median {med:.2f}); device busy per frame {fmt_ms(busy)} ms, idle share {idle}")


def event_median(fn, reps: int) -> float:
    """Median milliseconds of reps calls of fn, each between two CUDA events
    and followed by a synchronize (a frame's latency, its host work
    included), after one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def eager_frame(r: Renderer, cam) -> dict:
    """cam's frame through render_frame itself, eagerly, with r's arguments."""
    return render_frame(r.scene, *r.frame_uniforms(cam), **r._frame_kwargs)


def check_graph_frames(label: str, r: Renderer, cams, frames) -> None:
    """Each of frames (r.render(cam) after the capture) equal to cams' eager
    render_frame frame bit for bit: color, depth and the two counters."""
    check(r.uses_graphs and "frame" in r.graph_info(), f"{label}: the Renderer has no frame graph")
    same = []
    for cam, got in zip(cams, frames):
        want = eager_frame(r, cam)
        same.append(all(bool(torch.equal(got[k], want[k])) for k in GRAPH_OUTPUTS))
    print(f"{label} graph frames vs eager render_frame, bit for bit ({', '.join(GRAPH_OUTPUTS)}): {same}")
    check(all(same), f"{label}: a graph frame differs from the eager frame")


def host_ms(fn, n: int = 6) -> list:
    """Host milliseconds of each of n calls of fn back to back, no
    synchronize between them (one before and one after)."""
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return out


def graph_costs(label: str, r: Renderer, cam, card: str, reps: int = 6) -> dict:
    """What r's frame graph cost and what it saves: capture ms and pool
    bytes; graph and eager frame medians by events (event_median); host ms
    per r.render call (median of 6 calls back to back), and apart the
    median host ms of frame_uniforms and of the graph's replay() alone;
    device busy per graph frame (torch.profiler) and the idle share it
    leaves of the graph frame; the device ms of the copies out of the
    graph's outputs that each call makes."""
    vp, cp = r.frame_uniforms(cam)
    graph_ms = event_median(lambda: r.render_with_uniforms(vp, cp), reps)
    eager_ms = event_median(lambda: render_frame(r.scene, vp, cp, **r._frame_kwargs), reps)
    host = host_ms(lambda: r.render(cam))
    uniforms_ms = float(np.median(host_ms(lambda: r.frame_uniforms(cam))))
    graph = r._frame_fn("frame")
    replay_ms = float(np.median(host_ms(graph.replay)))
    copies_ms = device_ms(lambda: [v.clone() for v in graph._outputs.values()], 20)
    busy = device_ms(lambda: r.render_with_uniforms(vp, cp), 3)
    info = r.graph_info()["frame"]
    out = dict(capture_ms=info["capture_ms"], pool_bytes=info["pool_bytes"], graph_ms=graph_ms, eager_ms=eager_ms,
               host_ms=float(np.median(host)), busy_ms=busy, idle=None if busy is None else 1.0 - busy / graph_ms,
               copies_ms=copies_ms)
    idle = "not measured" if busy is None else f"{out['idle']:.3f}"
    print(f"{label} graph: capture {out['capture_ms']:.1f} ms, pool {out['pool_bytes']} B; frame median by events "
          f"{graph_ms:.3f} ms vs eager {eager_ms:.3f} ms ({graph_ms / eager_ms:.3f}x); host ms per render call "
          f"{out['host_ms']:.4f} (" + ", ".join(f"{h:.3f}" for h in host)
          + f"; of it frame_uniforms {uniforms_ms:.4f}, replay() {replay_ms:.4f}); device busy {fmt_ms(busy)} ms, "
          f"idle share {idle}; the copies out of the outputs {fmt_ms(copies_ms)} device ms [{card}]")
    return out


def graph_frames(r: Renderer, cams, window_frames, card: str) -> dict:
    """The window graph beyond its track: two frames held at once, the
    kernels the profiler sees in one replay, one launch per replayed frame,
    the G-buffer graph, a resize (1280x720) and back, and its costs.
    Returns the render kernels' device ms in the profiled replay."""
    check_graph_frames("window", r, cams, window_frames)
    K.reset_launches()
    held = [r.render(cams[0]), r.render(cams[1])]  # both replayed before either is read
    launches = dict(K.LAUNCHES)
    wants = [eager_frame(r, c) for c in cams[:2]]
    same = [all(bool(torch.equal(f[k], w[k])) for k in GRAPH_OUTPUTS) for f, w in zip(held, wants)]
    print(f"two window frames held at once: each equal to its eager frame {same}; launches {launches}")
    check(all(same), "a held graph frame was overwritten by the next replay")
    check(all(launches[name] == 2 for name in RENDER_KERNELS), "graph replays: not one launch per kernel a frame")

    from torch.profiler import ProfilerActivity, profile

    vp, cp = r.frame_uniforms(cams[2])
    r.render_with_uniforms(vp, cp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r.render_with_uniforms(vp, cp)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    mine = {name: [e for e in ops if re.search(rf"(?<![A-Za-z0-9_]){name}_kernel\b", e.key)]
            for name in RENDER_KERNELS}
    seen = {name: sum(e.count for e in es) for name, es in mine.items()}
    kernel_ms = {name: sum(e.self_device_time_total for e in es) / 1e3 for name, es in mine.items()}
    print(f"torch.profiler over one window replay: {sum(e.count for e in ops)} device operations, "
          f"{sum(e.self_device_time_total for e in ops) / 1e3:.4f} device ms; render kernels seen {seen}, their "
          "device ms " + ", ".join(f"{k} {v:.4f}" for k, v in kernel_ms.items()))
    check(all(n == 1 for n in seen.values()), "the profiler does not list each render kernel once in a replay")

    gb = r.debug_gbuf(cams[0], with_fid=True)
    gb = r.debug_gbuf(cams[0], with_fid=True)  # the replay
    kw = dict(r._frame_kwargs, output="gbuf", shading="forward")
    want = render_frame(r.scene, *r.frame_uniforms(cams[0]), **kw)
    same_gbuf = bool(torch.equal(gb[0], want["gbuf"])) and bool(torch.equal(gb[1], want["fid"]))
    print(f"debug_gbuf graph: G-buffer and face ids equal to the eager frame's {same_gbuf}; "
          f"capture {r.graph_info()['gbuf']['capture_ms']:.1f} ms, pool {r.graph_info()['gbuf']['pool_bytes']} B")
    check(same_gbuf, "the debug_gbuf graph differs from the eager G-buffer")

    r.recreate_swapchain(1280, 720)
    check(r.graph_info() == {}, "recreate_swapchain kept the graphs")
    small = [r.render(c) for c in cams[:GATHER_FRAMES + 1]][1:]  # the first captures
    check(all(tuple(f["color"].shape) == (4, 720, 1280) for f in small), "1280x720: graph frame shape")
    check_graph_frames("window 1280x720", r, cams[1:GATHER_FRAMES + 1], small)
    r.recreate_swapchain(WIDTH, HEIGHT)
    r.render(cams[0])
    graph_costs("window", r, cams[0], card)
    return kernel_ms


def gather_paths(scene, cams, window_frames, card: str) -> dict:
    """The gather and deferred paths on the first GATHER_FRAMES cameras,
    held against the window path's frames and against each other. Returns
    {label: (its Renderer, its frames, the launches of its track)}."""
    n_rendered = GATHER_FRAMES + 1
    track = cams[:GATHER_FRAMES]
    paths = {}
    for label, change in (("gather", dict(sampler="gather")), ("deferred", dict(shading="deferred"))):
        r = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT, **change))
        texels = r.scene["atlas"]["texels"]
        torch.cuda.synchronize()
        print(f"{label} path: sampler {r.sampler}, texels {tuple(texels.shape)} {r.texture_dtype} "
              f"({texels.numel() * texels.element_size() / 1e9:.2f} GB)")
        K.reset_launches()
        frames, times = run_track(r, track)
        launches = dict(K.LAUNCHES)
        print(f"{label} path: {n_rendered} frames (1 warm-up), launches {launches}")
        print_times(label, times, r, track[0])
        want = path_want(label, n_rendered)
        for name in KERNELS:
            check(launches[name] == want.get(name, 0),
                  f"{label}: {name} launched {launches[name]} times for {n_rendered} frames, want {want.get(name, 0)}")
        check_frames(frames, label)
        check_graph_frames(label, r, track, frames)
        graph_costs(label, r, track[0], card, reps=3)
        print_stages(label, stage_breakdown(r, cams[0]))
        paths[label] = (r, frames, launches)

    r_g, gather, _ = paths["gather"]
    _, deferred, _ = paths["deferred"]
    for k in range(GATHER_FRAMES):
        check(bool(torch.equal(gather[k]["depth"], window_frames[k]["depth"])), f"gather frame {k}: depth differs "
              "from the window path's")
    diffs = [(d["color"].int() - g["color"].int()).abs() for d, g in zip(deferred, gather)]
    d_lsb = [int(d.max()) for d in diffs]
    d_px = [int((d.amax(dim=0) > 0).sum()) for d in diffs]
    d_depth = [bool(torch.equal(d["depth"], g["depth"])) for d, g in zip(deferred, gather)]
    print(f"deferred vs gather per frame: color max LSB {d_lsb}, pixels differing {d_px}, depth equal {d_depth}")
    check(max(d_lsb) == 0 and all(d_depth), "the deferred frames differ from the forward+gather frames")
    gw = (gather[0]["color"].int() - window_frames[0]["color"].int()).abs()
    gw_px = gw.amax(dim=0)
    print(f"gather vs window, frame 0: max {int(gw.max())} LSB, pixels above 0: {int((gw_px > 0).sum())}, "
          f"above 1: {int((gw_px > 1).sum())}, above 2: {int((gw_px > 2).sum())}")
    check(int(gw.max()) <= 2, "gather frame 0 is more than 2 LSB from the window frame 0")

    sd = microbench.shade(r_g.scene["atlas"]["texels"], torch.device("cuda"))
    print(f"microbench shade on the orbit atlas {sd['atlas_shape']} {sd['atlas_dtype']} "
          f"({sd['atlas_mb']:.1f} MB), synthetic 1088x1920 G-buffer: shade_gbuffer kernel {sd['kernel_ms']:.4f} ms, "
          f"plain shade_gbuffer {sd['full_ms']:.3f} ms, "
          f"gather-only (1 row/px) {sd['gather_only_ms']:.3f} ms, trilerp-only {sd['trilerp_only_ms']:.3f} ms")
    return paths


def slab_kernels(r: Renderer, cam, card: str) -> None:
    """Raster and resolve at a global row offset: the middle slab (the
    second of four) of frame 0, each against its plain version (raster
    exact; resolve integer planes exact, float planes kernel_phases' rule)
    and against the same rows of the kernels' whole frame, bit for bit."""
    kw = r._frame_kwargs
    sc = r.scene
    th, tw, tx = kw["tile_h"], kw["tile_w"], r.tiles_x
    per = -(-r.tiles_y // SLAB_SPLIT)  # tile rows per slab, padded as parallel.py pads them
    row0 = per
    vp, _ = r.frame_uniforms(cam)
    so = geometry.triangle_setup(geometry.transform_corners(sc["corner_world"], vp), None, sc["n_faces"],
                                 kw["width"], kw["height"])
    bins = geometry.bin_pairs(so["aabb"], so["valid"], tx, per, tw, th, ty_base=row0)
    rkw = dict(tile_h=th, tile_w=tw, tiles_x=tx, tiles_y=per, clear_depth=kw["clear_depth"], tile_row_offset=row0)
    args = (so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"])
    vis = raster.rasterize_tiles(*args, **rkw)
    vis_p = raster.rasterize_tiles_plain(*args, **rkw)
    full_bins = geometry.bin_pairs(so["aabb"], so["valid"], tx, r.tiles_y, tw, th)
    full = raster.rasterize_tiles(so["setup"], so["aabb"], full_bins["pair_faces"], full_bins["offsets"],
                                  **dict(rkw, tiles_y=r.tiles_y, tile_row_offset=0))
    rows = slice(row0 * th, (row0 + per) * th)
    torch.cuda.synchronize()
    bad = int((vis != vis_p).sum())
    same_rows = bool(torch.equal(vis, full[:, rows]))
    covered = vis[1] >= 0
    ms = cuda_ms(lambda: raster.rasterize_tiles(*args, **rkw), 20)
    print(f"slab kernels: tile rows {row0}-{row0 + per - 1} of {r.tiles_y} (pixel rows {rows.start}-{rows.stop - 1}), "
          f"{int(bins['offsets'][-1])} pairs, {int(covered.sum())} covered px; raster vs plain: {bad} values "
          f"differ; equal to the whole frame's rows {same_rows}; {ms:.4f} ms [{card}]")
    check(bad == 0 and same_rows and int(covered.sum()) > 10000, "raster at a row offset disagrees")
    guard_raster("slab_kernels", so, bins, vis, **rkw)

    attrs = resolve.pack_resolve_attrs(so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"],
                                       sc["face_tex"], sc["atlas"])
    ma = kw["max_anisotropy"]
    g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma, tile_row_offset=row0, tile_h=th)
    g_p = resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=ma, tile_row_offset=row0, tile_h=th)
    g_full = resolve.resolve_gbuffer(full, attrs, max_anisotropy=ma)
    torch.cuda.synchronize()
    flip = (g[19] != g_p[19]) & covered
    keep = ~flip
    int_bad = int(sum(((g[i] != g_p[i]) & keep).sum() for i in resolve.INT_PLANES))
    float_bad = int((~torch.isclose(g[FLOAT_PLANES][:, keep], g_p[FLOAT_PLANES][:, keep], rtol=1e-5,
                                    atol=1e-6)).sum())
    same_rows = bool(torch.equal(g, g_full[:, rows]))
    ms = cuda_ms(lambda: resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma, tile_row_offset=row0, tile_h=th), 20)
    print(f"slab kernels: resolve vs plain: l0 flips {int(flip.sum())}, integer-plane values differing {int_bad}, "
          f"float-plane values outside rtol 1e-5/atol 1e-6 {float_bad}; equal to the whole frame's rows {same_rows}; "
          f"{ms:.4f} ms [{card}]")
    check(int(flip.sum()) <= 0.001 * int(covered.sum()) and int_bad == 0 and float_bad == 0 and same_rows,
          "resolve at a row offset disagrees")
    guard_resolve("slab_kernels", vis, attrs, g, max_anisotropy=ma, y_offset=row0 * th)
    print_guards("slab_kernels", card)


def slab_frames(renderers: dict, cam, card: str) -> dict:
    """make_sharded_renderer (a CUDA graph of the slab frame) against the
    single Renderer frame of cam (a graph replay): 2 and 8 slabs on the
    window path, 2 on gather and on deferred. The first call renders
    eagerly and captures, the second replays: each equal to the single
    frame bit for bit (color, depth, the counters), and raster (and on the
    forward paths resolve, on the window path plan and sample, gather or
    deferred on theirs) launched once per slab in the replay, the counts
    from zero around it. Returns each path's launches of its last replay
    (the window path's 8 slabs)."""
    slab_launches = {}
    for label, r in renderers.items():
        vp, cp = r.frame_uniforms(cam)
        single = r.render_with_uniforms(vp, cp)
        single_ms = cuda_ms(lambda: r.render_with_uniforms(vp, cp), 5)
        for n in SLABS[label]:
            fn = make_sharded_renderer(r.scene, r.config, n, WIDTH, HEIGHT)
            check(isinstance(fn, FrameGraph), "make_sharded_renderer on the card is not a graph")
            first = fn(r.scene, vp, cp)
            K.reset_launches()
            out = fn(r.scene, vp, cp)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            same = {f"{which} {k}": bool(torch.equal(f[k], single[k]))
                    for which, f in (("eager", first), ("graph", out)) for k in GRAPH_OUTPUTS}
            ms = cuda_ms(lambda: fn(r.scene, vp, cp), 5)
            print(f"slab frame, {label}, {n} slabs ({fn.fn.keywords['tiles_y_per_slab']} tile rows each): equal to "
                  f"the single frame {same}, launches {launches}; capture {fn.capture_ms:.1f} ms, pool "
                  f"{fn.pool_bytes} B; graph {ms:.3f} ms a frame vs {single_ms:.3f} ms single "
                  f"({ms / single_ms:.2f}x) [{card}]")
            check(all(same.values()), f"{label}: {n} slabs differ from the frame")
            fn.close()
            want = path_want(label, n)
            for name in KERNELS:
                check(launches[name] == want[name],
                      f"{label}, {n} slabs: {name} launched {launches[name]} times, want {want[name]}")
            slab_launches[label] = launches
    return slab_launches


def sequential_slabs(n: int, kw: dict):
    """The n-slab frame with its slabs one after another (render_slabs of
    one slab at a time, each joined before the next forks): the slab frame
    as make_sharded_renderer captured it before its slabs ran
    concurrently, the yardstick of the concurrent one."""
    def fn(scene, vp, cp):
        parts = [parallel.render_slabs(scene, vp, cp, slabs=(i,), **kw) for i in range(n)]
        return {
            "color": torch.cat([p["color"] for p in parts], dim=1)[:, :kw["height"], :kw["width"]],
            "depth": torch.cat([p["depth"] for p in parts], dim=0)[:kw["height"], :kw["width"]],
            "bin_overflow": torch.stack([p["bin_overflow"] for p in parts]).sum(dtype=torch.int32),
            "window_miss_px": torch.stack([p["window_miss_px"] for p in parts]).sum(dtype=torch.int32),
        }
    return fn


def multi_device(renderers: dict, cam, card: str) -> dict:
    """make_sharded_renderer over a device list, the mesh of the
    reference's shard_map: cuda:0..n-1 where the machine has two cards or
    more, else MESH_SLABS entries of cuda:0 (the line says which). On the
    window, gather and deferred paths the first call renders eagerly and captures
    the graphs (one per device), the second replays them: both equal the
    single Renderer frame bit for bit (color, depth, both counters, on
    cuda:0), and each render kernel of the path launched once per slab in
    the replay (counts from zero around it). Beside it, by event_median:
    the single frame and the sequential n-slab graph (sequential_slabs);
    the device ms of both summed over their streams (torch.profiler); the
    graphs' capture ms and pool bytes and each device's replica bytes.
    Returns each path's launches in its replay."""
    count = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(count)] if count >= 2 else ["cuda:0"] * MESH_SLABS
    n = len(devices)
    which = f"{count} cards, one slab each" if count >= 2 else f"one card, {n} entries of cuda:0"
    mesh_launches = {}
    for label, r in renderers.items():
        vp, cp = r.frame_uniforms(cam)
        single = r.render_with_uniforms(vp, cp)
        fn = make_sharded_renderer(r.scene, r.config, devices, WIDTH, HEIGHT)
        first = fn(r.scene, vp, cp)
        K.reset_launches()
        out = fn(r.scene, vp, cp)
        for i in range(count):
            torch.cuda.synchronize(i)
        launches = dict(K.LAUNCHES)
        same = {f"{which_call} {k}": bool(torch.equal(f[k], single[k])) and f[k].device == single[k].device
                for which_call, f in (("eager", first), ("graph", out)) for k in GRAPH_OUTPUTS}
        graphs = parallel.frame_graphs(fn)
        replicas = fn.replicas if isinstance(fn, parallel.MeshFrame) else {}
        replica_bytes = {str(d): 0 if s is r.scene else scene_bytes(s) for d, s in replicas.items()} or {"cuda:0": 0}
        mesh_ms = event_median(lambda: fn(r.scene, vp, cp), 6)
        single_ms = event_median(lambda: r.render_with_uniforms(vp, cp), 6)
        kw = {k: v for k, v in make_sharded_renderer(r.scene, r.config, n, WIDTH, HEIGHT).fn.keywords.items()
              if k != "n_slabs"}
        seq = FrameGraph(sequential_slabs(n, kw), name=f"sequential {n}-slab frame")
        seq_first = seq(r.scene, vp, cp)
        seq_same = all(bool(torch.equal(seq_first[k], single[k])) for k in GRAPH_OUTPUTS)
        seq_ms = event_median(lambda: seq(r.scene, vp, cp), 6)
        # Device time summed over the streams (torch.profiler): above the
        # frame's ms where the slabs' kernels overlap.
        busy, seq_busy = (device_ms(lambda f=f: f(r.scene, vp, cp), 3) for f in (fn, seq))
        print(f"multi_device, {label}, devices {devices} ({which}), {kw['tiles_y_per_slab']} tile rows a slab: equal "
              f"to the single frame {same}, launches in the replay {launches}; graph {mesh_ms:.3f} ms a frame vs "
              f"single {single_ms:.3f} ms ({mesh_ms / single_ms:.2f}x) vs the sequential {n}-slab graph {seq_ms:.3f} "
              f"ms ({mesh_ms / seq_ms:.3f}x; its frame equal {seq_same}); device ms summed over the streams "
              f"{fmt_ms(busy)} (sequential {fmt_ms(seq_busy)}); capture "
              f"{[round(g.capture_ms, 1) for g in graphs]} ms (sequential {seq.capture_ms:.1f}), pool "
              f"{[g.pool_bytes for g in graphs]} B (sequential {seq.pool_bytes}), replica bytes {replica_bytes} "
              f"[{card}]")
        check(all(same.values()) and seq_same, f"multi_device, {label}: the mesh frame differs from the frame")
        want = path_want(label, n)
        for name in KERNELS:
            check(launches[name] == want[name],
                  f"multi_device, {label}: {name} launched {launches[name]} times, want {want[name]}")
        for g in graphs + [seq]:
            g.close()
        mesh_launches[label] = launches
    return mesh_launches


def scan_path(scene, r: Renderer, cams, window_frames, card: str) -> dict:
    """binning="scan": a warm-up frame and SCAN_FRAMES track frames equal
    to the window path's pairs frames bit for bit; frame 0's counts,
    offsets and per-tile face sets equal bin_pairs'; a pair buffer of half
    the pairs counts the rest as overflow and the frame renders. Beside
    it, the binning stage's event ms under each binner. Returns the
    launches of the scan track."""
    rs = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT, binning="scan"))
    K.reset_launches()
    frames, times = run_track(rs, cams[:SCAN_FRAMES])
    launches = dict(K.LAUNCHES)
    n_rendered = SCAN_FRAMES + 1
    print(f"scan path: bin_capacity {rs.bin_capacity}, {n_rendered} frames (1 warm-up), launches {launches}")
    for name in KERNELS:
        want = n_rendered if name in RENDER_KERNELS else 0
        check(launches[name] == want, f"scan: {name} launched {launches[name]} times for {n_rendered} frames")
    for k, f in enumerate(frames):
        same = all(bool(torch.equal(f[x], window_frames[k][x])) for x in ("color", "depth"))
        check(same and int(f["bin_overflow"]) == 0, f"scan frame {k} differs from the pairs frame")
    check_graph_frames("scan", rs, cams[:SCAN_FRAMES], frames)
    print_times("scan", times, rs, cams[0])

    kw = rs._frame_kwargs
    vp, _ = rs.frame_uniforms(cams[0])
    sc = rs.scene
    so = geometry.triangle_setup(geometry.transform_corners(sc["corner_world"], vp), None, sc["n_faces"],
                                 kw["width"], kw["height"])
    grid = (so["aabb"], so["valid"], rs.tiles_x, rs.tiles_y, kw["tile_w"], kw["tile_h"])
    pairs = geometry.bin_pairs(*grid)
    scan = geometry.bin_triangles(*grid, rs.bin_capacity)
    n = int(pairs["offsets"][-1])
    # Per tile the same faces: bin_pairs' (tile, face) keys sorted are the
    # scan's draw-order lists.
    keys = torch.sort((pairs["pair_tiles"][:n].long() << geometry.FACE_BITS) | pairs["pair_faces"][:n].long()).values
    same_sets = bool(torch.equal((keys & ((1 << geometry.FACE_BITS) - 1)).int(), scan["pair_faces"][:n]))
    same_bins = all(bool(torch.equal(scan[k], pairs[k])) for k in ("counts", "offsets"))
    cap = n // 2
    trunc = geometry.bin_triangles(*grid, cap)
    rt = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT, binning="scan", bin_capacity=cap))
    tf = rt.render(cams[0])
    torch.cuda.synchronize()
    t_over, f_over = int(trunc["overflow"]), int(tf["bin_overflow"])
    cover = float((tf["depth"] > 0).float().mean())
    pairs_ms = cuda_ms(lambda: geometry.bin_pairs(*grid), 20)
    scan_ms = cuda_ms(lambda: geometry.bin_triangles(*grid, rs.bin_capacity), 20)
    print(f"scan frame 0: {n} pairs, counts and offsets equal to bin_pairs' {same_bins}, per-tile face sets equal "
          f"{same_sets}; capacity {cap}: overflow {t_over} (want {n - cap}); Renderer at bin_capacity "
          f"{rt.bin_capacity}: bin_overflow {f_over} (want {n - rt.bin_capacity}), coverage {cover:.3f}; binning "
          f"stage by events: scan {scan_ms:.4f} ms vs pairs {pairs_ms:.4f} ms [{card}]")
    check(same_bins and same_sets, "scan bins differ from pair bins")
    # The frame renders: the tiles past the buffer lose their faces (the
    # floor's lower rows), the first tiles keep theirs.
    check(t_over == n - cap and f_over == n - rt.bin_capacity and cover > 0.0
          and bool(torch.isfinite(tf["depth"]).all()), "scan truncation")
    return launches


def tool_phase(scene, seed: int, card: str, device="cuda") -> None:
    """Each analysis tool once on the scene already built, at small frame
    counts, its lines printed; the G-buffer dump of residual_analysis and
    sampler_sim lives in a temporary directory."""
    def show(name, lines):
        for line in lines:
            print(f"tool {name}: {line}")

    t0 = time.perf_counter()
    dims = dict(width=WIDTH, height=HEIGHT, device=device)
    show("profile_stages", [json.dumps(profile_stages.profile(scene, frames=2, warmup=1, **dims))])
    show("sample_stage_probe", [json.dumps({"cum_ms": sample_stage_probe.probe(
        scene, frames=2, warmup=1, stages=("plan", "sample", "frame"), **dims)})])
    show("profile_sampler", [json.dumps(profile_sampler.profile(scene, frames=2, warmup=1, **dims))])
    show("sampler_plan_stats", sampler_plan_stats.stats(scene, frames=2, **dims))
    lines, worst = check_sampler.check(scene, frames=2, device=device)
    show("check_sampler", lines)
    # The tool's own verdict is its 1-LSB budget; the run holds the two
    # samplers to the 2 LSB of gather_paths (tests/test_sampler.py:76).
    check(worst <= 2, f"check_sampler: window and gather differ by {worst} LSB")
    show("aniso_mode_stats", [json.dumps(aniso_mode_stats.stats(scene, **dims))])
    with tempfile.TemporaryDirectory() as d:
        show("residual_analysis", residual_analysis.analyse(scene, seed=seed, gbuf_dir=d, **dims))
        path = residual_analysis.gbuf_path(d, "orbit", seed, WIDTH, HEIGHT, 0.4)
        show("sampler_sim", sampler_sim.simulate(np.load(path)["gbuf"]))
    print(f"tools: 8 ran in {time.perf_counter() - t0:.1f} s [{card}]")


def padded_kernels(rr: Renderer, cam, card: str) -> None:
    """At rr's target off the tile grid, before the crop: the G-buffer and
    face ids of debug_gbuf (a graph replay) against the plain versions'
    (eager, inside plain_kernels()), face ids exact, integer planes exact,
    float planes kernel_phases' rule; then the plan and sample kernels on
    that G-buffer against their plain versions (plan exact, the uncropped
    sRGB u8 framebuffer within 1 LSB). Each over the whole padded frame,
    with the pixels past the frame's width or height counted apart."""
    rr.debug_gbuf(cam, with_fid=True)  # the eager first call, which captures
    g, fid = rr.debug_gbuf(cam, with_fid=True)
    with K.plain_kernels():
        g_p, fid_p = rr.debug_gbuf(cam, with_fid=True)
    hp, wp = fid.shape
    past = torch.ones((hp, wp), dtype=torch.bool, device=fid.device)
    past[:rr.height, :rr.width] = False
    covered = fid >= 0
    fid_bad = int((fid != fid_p).sum())
    flip = (g[19] != g_p[19]) & covered
    keep = ~flip
    int_bad = int(sum(((g[i] != g_p[i]) & keep).sum() for i in resolve.INT_PLANES))
    float_bad = int((~torch.isclose(g[FLOAT_PLANES][:, keep], g_p[FLOAT_PLANES][:, keep], rtol=1e-5,
                                    atol=1e-6)).sum())
    kw = rr._frame_kwargs
    tiles = dict(tiles_x=rr.tiles_x, tiles_y=rr.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"])
    ma = kw["max_anisotropy"]
    plan = sampler.plan_tiles(g, max_anisotropy=ma, **tiles)
    plan_p = sampler.plan_tiles_plain(g, max_anisotropy=ma, **tiles)
    plan_bad = int((plan["table"] != plan_p["table"]).sum()) + int((plan["assign"] != plan_p["assign"]).sum())
    page, (_, cp) = rr.scene["atlas"]["page"], rr.frame_uniforms(cam)
    skw = sample_kwargs(kw, tiles)
    fb = sampler.sample_tiles(g, page, plan, cp, **skw)
    fb_p = sampler.sample_tiles_plain(g, page, plan, cp, **skw)
    diff = (present.encode_srgb_u8(fb, wp, hp).int() - present.encode_srgb_u8(fb_p, wp, hp).int()).abs().amax(0)
    lsb, lsb_past = int(diff.max()), int(diff[past].max())
    print(f"padded frame {rr.width}x{rr.height} -> {wp}x{hp} ({rr.tiles_x}x{rr.tiles_y} tiles; the last tile column "
          f"holds {rr.width - (rr.tiles_x - 1) * kw['tile_w']} frame columns): covered px {int(covered.sum())}, of "
          f"them past the frame {int((covered & past).sum())} of {int(past.sum())}; kernels vs plain, whole padded "
          f"frame: face ids differing {fid_bad} (past the frame {int(((fid != fid_p) & past).sum())}), l0 flips "
          f"{int(flip.sum())}, integer-plane values {int_bad}, float-plane values outside rtol 1e-5/atol 1e-6 "
          f"{float_bad}, plan words and assignments {plan_bad}, sampled u8 max {lsb} LSB (past the frame "
          f"{lsb_past}) [{card}]")
    check(fid_bad == 0 and int(flip.sum()) <= 0.001 * int(covered.sum()) and int_bad == 0 and float_bad == 0
          and plan_bad == 0 and lsb <= 1, f"{rr.width}x{rr.height}: a kernel disagrees in the padded frame")

    # Each kernel once more into guarded outputs, raster and resolve on the
    # frame's own setup and bins (their eager wrappers give the graph's ids).
    vp, _ = rr.frame_uniforms(cam)
    sc = rr.scene
    so = geometry.triangle_setup(geometry.transform_corners(sc["corner_world"], vp), None, sc["n_faces"],
                                 kw["width"], kw["height"])
    bins = geometry.bin_pairs(so["aabb"], so["valid"], rr.tiles_x, rr.tiles_y, kw["tile_w"], kw["tile_h"])
    vis = raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                 clear_depth=kw["clear_depth"], **tiles)
    attrs = resolve.pack_resolve_attrs(so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"],
                                       sc["face_tex"], sc["atlas"])
    check(bool(torch.equal(vis[1], fid)), f"{rr.width}x{rr.height}: the eager raster's face ids differ from the graph's")
    phase = f"padded_kernels {rr.width}x{rr.height}"
    guard_raster(phase, so, bins, vis, clear_depth=kw["clear_depth"], **tiles)
    guard_resolve(phase, vis, attrs, g, max_anisotropy=ma)
    guard_plan(phase, g, plan, max_anisotropy=ma, **tiles)
    guard_sample(phase, g, page, plan, cp, fb, **skw)
    print_guards(phase, card)


def pose_tools(scene, r: Renderer, card: str) -> dict:
    """fit_pose and parity_render on the orbit scene already built, at
    frame sizes off the 128-px tile grid. Returns the render kernels'
    launches over the POSE_ITERS-pose search."""
    t_phase = time.perf_counter()
    specs = [{"position": orbit_camera(a).position.tolist(), "target": list(POSE_SEARCH["center"])}
             for a in PARITY_ANGLES]
    cams = [orbit_camera(a) for a in PARITY_ANGLES]
    checkers = {}
    for w, h in PARITY_SIZES:
        rr = checkers[w, h] = Renderer(scene, RendererConfig(width=w, height=h))
        K.reset_launches()
        images = parity_render.render_poses(scene, specs, width=w, height=h)
        launches = dict(K.LAUNCHES)
        got = [rr.render(c) for c in cams]
        with K.plain_kernels():
            plain = [rr.render(c) for c in cams]
            plain_images = [parity_render.render_pose(rr, spec) for spec in specs]
        lsb = max(int(np.abs(a.astype(np.int32) - b).max()) for a, b in zip(images, plain_images))
        d_eq = all(bool(torch.equal(a["depth"], b["depth"])) for a, b in zip(got, plain))
        overflow = [int(f["bin_overflow"]) for f in got + plain]
        side = parity_render.side_by_side(images[0], images[0])
        print(f"parity_render.render_poses at {w}x{h}, {len(specs)} orbit poses: images {images[0].shape}, "
              f"side_by_side {side.shape}, launches {launches}; vs plain: color max {lsb} LSB, depth equal {d_eq}, "
              f"bin_overflow {overflow}, coverage " + ", ".join(f"{float((f['depth'] > 0).float().mean()):.3f}"
                                                              for f in got))
        check(images[0].shape == (h, w, 3) and side.shape == (h, 2 * w + parity_render.BAND_PX, 3),
              f"{w}x{h}: render_poses' shapes")
        check(lsb <= 1 and d_eq and not any(overflow), f"{w}x{h}: off-grid frames disagree with the plain versions")
        check(all(launches[n] == len(specs) for n in RENDER_KERNELS), f"{w}x{h}: not one launch per pose")
        padded_kernels(rr, cams[0], card)

    # The screenshot-sized graph frame against the 1280x720 one, by events
    # only: torch.profiler over a replay of a graph captured before another
    # graph was destroyed (the searches' Renderers drop theirs) crashes the
    # process inside cudaGraphLaunch, in CUPTI's callback into libcuda;
    # tpurast_torch/tools/profiler_graph_crash.py reproduces it with torch
    # alone (PERF.md, section 7).
    big = checkers[PARITY_SIZES[0]]
    off_ms = event_median(lambda: big.render(cams[0]), 6)
    r.recreate_swapchain(1280, 720)
    on_ms = event_median(lambda: r.render(cams[0]), 6)  # its first call captures
    on_tiles = (r.tiles_x, r.tiles_y)
    r.recreate_swapchain(WIDTH, HEIGHT)
    print(f"graph frame by events, median of 6: {big.width}x{big.height} ({big.tiles_x}x{big.tiles_y} tiles) "
          f"{off_ms:.3f} ms vs 1280x720 ({on_tiles[0]}x{on_tiles[1]} tiles) {on_ms:.3f} ms ({off_ms / on_ms:.3f}x) "
          f"[{card}]")

    # The target: the coverage mask of the orbit camera at POSE_TRUE.
    true_cam = orbit_camera(POSE_TRUE)
    target = checkers[POSE_W, POSE_H]
    mask_ref = (target.render(true_cam)["depth"] > 0).cpu().numpy()
    check(0.05 <= mask_ref.mean() <= 0.95, f"pose target coverage {mask_ref.mean():.3f}")
    K.reset_launches()
    log = []
    t0 = time.perf_counter()
    score, pos, tgt, fr = fit_pose.fit(scene, mask_ref, width=POSE_W, height=POSE_H, iters=POSE_ITERS,
                                       log=log.append, **POSE_SEARCH)
    search_s = time.perf_counter() - t0
    pose_launches = dict(K.LAUNCHES)
    for name in KERNELS:
        want = POSE_ITERS if name in RENDER_KERNELS else 0
        check(pose_launches[name] == want, f"fit_pose: {name} launched {pose_launches[name]} times, want {want}")
    true_iou = fit_pose.iou((fr.render(true_cam)["depth"] > 0).cpu().numpy(), mask_ref)
    check(true_iou == 1.0, f"fit_pose: the true pose scores IoU {true_iou} after {POSE_ITERS} replays")

    # A pose: one replay and one read-back of its mask, on the host's clock.
    rng = np.random.default_rng(1)
    poses = [Camera.from_target(np.asarray(pos + rng.normal(0, 0.5, 3), np.float32),
                                         np.asarray(tgt, np.float32)) for _ in range(50)]
    torch.cuda.synchronize()
    per_pose = []
    for cam in poses:
        t0 = time.perf_counter()
        (fr.render(cam)["depth"] > 0).cpu().numpy()
        per_pose.append((time.perf_counter() - t0) * 1e3)
    busy = device_ms(lambda: fr.render(poses[0]), 3)
    capture = fr.graph_info()["frame"]["capture_ms"]
    pose_ms = float(np.median(per_pose))
    print(f"fit_pose at {POSE_W}x{POSE_H}, {POSE_ITERS} poses around {POSE_SEARCH}: best IoU {score:.4f} at pos "
          f"{pos.round(3).tolist()} tgt {tgt.round(3).tolist()} ({len(log)} improvements); the true pose's mask "
          f"after the search IoU {true_iou}; launches {pose_launches}; the search {search_s:.2f} s with the "
          f"Renderer's upload and capture ({capture:.1f} ms); ms per pose (replay + read-back, host clock, median "
          f"of {len(per_pose)}) {pose_ms:.3f} (mean {np.mean(per_pose):.3f}), {1e3 / pose_ms:.1f} poses/s; device "
          f"busy per pose {fmt_ms(busy)} ms, host share "
          f"{'not measured' if busy is None else f'{1.0 - busy / pose_ms:.3f}'} [{card}]")

    # The first POSE_PLAIN_ITERS iterations again, kernels and plain versions.
    runs = {}
    for label, ctx in (("kernels", contextlib.nullcontext()), ("plain", K.plain_kernels())):
        lines = []
        K.reset_launches()
        t0 = time.perf_counter()
        with ctx:
            res = fit_pose.fit(scene, mask_ref, width=POSE_W, height=POSE_H, iters=POSE_PLAIN_ITERS,
                               log=lines.append, **POSE_SEARCH)
        runs[label] = dict(lines=lines, score=res[0], pos=res[1], tgt=res[2], launches=dict(K.LAUNCHES),
                           s=time.perf_counter() - t0)
    kr, pr = runs["kernels"], runs["plain"]
    same = (kr["lines"] == pr["lines"] and kr["score"] == pr["score"] and np.array_equal(kr["pos"], pr["pos"])
            and np.array_equal(kr["tgt"], pr["tgt"]))
    print(f"fit_pose, {POSE_PLAIN_ITERS} iterations with the kernels ({kr['s']:.2f} s) and inside plain_kernels() "
          f"({pr['s']:.2f} s): {len(kr['lines'])} improvement lines, trajectories equal {same}, best IoU "
          f"{kr['score']:.4f} / {pr['score']:.4f}; launches {kr['launches']} / {pr['launches']}")
    for a, b in zip(kr["lines"], pr["lines"]):
        if a != b:
            print(f"  first difference: {a!r} vs {b!r}")
            break
    check(same, "fit_pose: the kernels' search differs from the plain versions'")
    check(all(kr["launches"][n] == POSE_PLAIN_ITERS for n in RENDER_KERNELS) and not any(pr["launches"].values()),
          "fit_pose: launches of the 40-pose searches")

    print(f"pose tools: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return pose_launches


def sanitize_cases(seed: int) -> int:
    """The case set that --sanitize-cases runs (under compute-sanitizer
    where the card's machine lets it attach): the orbit scene's frame 0 at
    1920x1080, 1282x721 and 320x180 (off the tile grid), at 1920x1080 with
    64x128 and 16x1024 tiles (the raster's sub-rectangle units, the plan's
    groups of 4096 px in scratch), the gather path on float16 rows at
    1920x1080 and on srgb8 rows at 320x180, the deferred path at 1282x721,
    the 2- and 8-slab frames, the scan path and the mesh frame
    (multi_device's devices), each
    eagerly (a graph's first call) and then as one graph replay, the two
    equal bit for bit; and the probes at odd shapes (vmem_take: 4095 rows,
    1,000,003 indices from an array off the 16-byte grid, some outside the
    table; plane_scale: plane 1 of a (3, 67, 381) buffer in 32x128, 7x3 and
    32x381 blocks), each eagerly and as a graph replay. Returns the number
    of cases."""
    scene = load_named_scene("orbit", seed=seed)
    cam = orbit_track(FRAMES)[0]
    r = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT))
    vp, cp = r.frame_uniforms(cam)
    count = torch.cuda.device_count()
    mesh = [f"cuda:{i}" for i in range(count)] if count >= 2 else ["cuda:0"] * MESH_SLABS
    cases = {}
    for w, h in ((WIDTH, HEIGHT), *PARITY_SIZES):
        rr = r if (w, h) == (WIDTH, HEIGHT) else Renderer(scene, RendererConfig(width=w, height=h))
        cases[f"window {w}x{h}"] = (rr._frame_fn("frame"), rr.scene, *rr.frame_uniforms(cam))
    for th, tw in SANITIZE_TILES:
        rt = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT, tile_h=th, tile_w=tw))
        cases[f"window {WIDTH}x{HEIGHT} at {th}x{tw} tiles"] = (rt._frame_fn("frame"), rt.scene,
                                                                *rt.frame_uniforms(cam))
    # The shade kernels: gather on float16 rows at 1920x1080, deferred on
    # float16 rows off the tile grid, gather on srgb8 rows at 320x180.
    for (w, h), change in (((WIDTH, HEIGHT), dict(sampler="gather")), (PARITY_SIZES[0], dict(shading="deferred")),
                           (PARITY_SIZES[1], dict(sampler="gather", texture_dtype="srgb8"))):
        rg = Renderer(scene, RendererConfig(width=w, height=h, **change))
        cases[f"{path_of(rg)} {rg.texture_dtype} {w}x{h}"] = (rg._frame_fn("frame"), rg.scene, *rg.frame_uniforms(cam))
    for n in SLABS["window"]:
        cases[f"{n}-slab frame"] = (make_sharded_renderer(r.scene, r.config, n, WIDTH, HEIGHT), r.scene, vp, cp)
    rs = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT, binning="scan"))
    cases["scan"] = (rs._frame_fn("frame"), r.scene, vp, cp)
    cases[f"mesh over {mesh}"] = (make_sharded_renderer(r.scene, r.config, mesh, WIDTH, HEIGHT), r.scene, vp, cp)
    dev = torch.device("cuda")
    tab = torch.rand((4095, 16), generator=microbench.generator(dev, 3), device=dev)
    idx = torch.randint(-3, 4098, (1_000_004,), generator=microbench.generator(dev, 4), device=dev,
                        dtype=torch.int32)
    # The graph's static copy of idx starts on the grid; the view one int
    # into it does not.
    cases["vmem_take 4095 rows, 1000003 indices"] = (Graph(lambda t, i: probes.vmem_take(t, i[1:])), tab, idx)
    src = torch.rand((3, 67, 381), generator=microbench.generator(dev, 2), device=dev)
    for bh, bw in ((32, 128), (7, 3), (32, 381)):
        fn = functools.partial(probes.plane_scale, plane=1, block_h=bh, block_w=bw)
        cases[f"plane_scale (3, 67, 381) plane 1, {bh}x{bw}"] = (Graph(fn), src)
    frame = None  # the 1920x1080 frame, which the slab, scan and mesh frames equal too
    for label, (fn, *args) in cases.items():
        eager = fn(*args)
        replay = fn(*args)
        for i in range(count):
            torch.cuda.synchronize(i)
        flat = [eager] if isinstance(eager, torch.Tensor) else list(eager.values())
        flat_r = [replay] if isinstance(replay, torch.Tensor) else list(replay.values())
        same = all(bool(torch.equal(a, b)) for a, b in zip(flat, flat_r))
        if frame is None:
            frame = eager
            check_frames([eager], label)
        elif args[0] is r.scene:
            same = same and all(bool(torch.equal(eager[k], frame[k])) for k in GRAPH_OUTPUTS)
        print(f"sanitize case {label}: eager and replay equal {same}"
              + (" (and equal to the 1920x1080 frame)" if args[0] is r.scene and frame is not eager else ""))
        check(same, f"sanitize case {label}: the replay differs from the eager call or the frame")
    print(f"sanitize cases: {len(cases)}")
    return len(cases)


SANITIZERS = ("memcheck", "racecheck", "synccheck")


def compute_sanitizer() -> tuple[str | None, str]:
    """compute-sanitizer's path (None where it is absent or cannot attach
    to this card) and what a probe under its memcheck said: one small torch
    program that touches the card."""
    path = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(path):
        return None, "absent (not on PATH, not /usr/local/cuda/bin/compute-sanitizer)"
    proc = subprocess.run([path, "--tool", "memcheck", "--error-exitcode", "1", sys.executable, "-c",
                           "import torch; torch.ones(8, device='cuda').sum().item()"],
                          capture_output=True, text=True, timeout=300)
    said = [ln.strip("= ").strip() for ln in (proc.stdout + proc.stderr).splitlines() if "Error" in ln]
    if proc.returncode != 0 or said:
        return None, f"{path} cannot attach to this card (exit {proc.returncode}: {'; '.join(said[:2])})"
    return path, f"{path} attaches"


def sanitizer_phase(seed: int, card: str) -> float:
    """--sanitize-cases in a subprocess under compute-sanitizer's memcheck
    (leaks not checked), racecheck and synccheck, each with
    --error-exitcode 1: one line per tool with the cases, the errors and
    the seconds. Where the tool is absent or cannot attach, a line says so
    and the case set runs once without a tool (the guard bands of the
    kernel-against-plain phases carry the card-side check). Returns the
    phase's seconds."""
    t_phase = time.perf_counter()
    path, why = compute_sanitizer()
    case_cmd = [sys.executable, os.path.abspath(__file__), "--sanitize-cases", "--seed", str(seed)]
    runs = [(tool, [path, "--tool", tool, *(["--leak-check", "no"] if tool == "memcheck" else []),
                    "--error-exitcode", "1", *case_cmd]) for tool in SANITIZERS] if path else [(None, case_cmd)]
    if path is None:
        print(f"compute-sanitizer: {why}; memcheck, racecheck and synccheck not run [{card}]")
    for tool, cmd in runs:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        cases = re.findall(r"^sanitize cases: (\d+)$", out, re.M)
        summary = re.findall(r"(?:ERROR SUMMARY|RACECHECK SUMMARY): .*", out)
        errors = sum(int(n) for n in re.findall(r"SUMMARY: (\d+) (?:errors|hazards)", out))
        label = f"compute-sanitizer --tool {tool}" if tool else "sanitize cases without a tool"
        print(f"{label}: cases {cases[0] if cases else 0}, errors {errors} ({'; '.join(summary) or 'no summary'}), "
              f"exit {proc.returncode}, {seconds:.1f} s [{card}]")
        if proc.returncode != 0 or not cases:
            print(out[-4000:])
        check(proc.returncode == 0 and errors == 0 and bool(cases), f"{label}: the case set failed")
    return time.perf_counter() - t_phase


BENCH_FRAMES, BENCH_WARMUP = 32, 4


def readback_ms(height: int, width: int) -> tuple[float, int]:
    """Milliseconds of one (height, width, 4) u8 frame's copy from the card
    into pinned host memory (CUDA events, mean of 20 after one), and its
    bytes."""
    src = torch.zeros((height, width, 4), dtype=torch.uint8, device="cuda")
    dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    return cuda_ms(lambda: dst.copy_(src, non_blocking=True), 20), src.numel()


def present_breakdown(r: Renderer, cams, frames: int = 24) -> None:
    """Where a frame of the present loop spends the host's time: enqueueing
    the render, Presenter.present (interleave launch, events, the copy's
    launch, the wait for the frame before, and the copy out of the pinned
    buffer), beside that last copy and the interleave kernel alone."""
    presenter = Presenter()
    render_ms, present_ms = [], []
    t_loop = time.perf_counter()
    for k in range(frames):
        t0 = time.perf_counter()
        color = r.render(cams[k % len(cams)])["color"]
        t1 = time.perf_counter()
        presenter.present(color)
        t2 = time.perf_counter()
        render_ms.append((t1 - t0) * 1e3)
        present_ms.append((t2 - t1) * 1e3)
    presenter.flush()
    loop_ms = (time.perf_counter() - t_loop) * 1e3 / frames
    torch.cuda.synchronize()
    pinned = torch.empty((HEIGHT, WIDTH, 4), dtype=torch.uint8, pin_memory=True)
    t0 = time.perf_counter()
    for _ in range(20):
        pinned.numpy().copy()
    copy_out_ms = (time.perf_counter() - t0) * 1e3 / 20
    interleave_ms = device_ms(lambda: color.permute(1, 2, 0).contiguous(), 20)
    print(f"present loop breakdown, {frames} frames at {WIDTH}x{HEIGHT}, host ms a frame (median): render enqueue "
          f"{np.median(render_ms):.3f}, Presenter.present {np.median(present_ms):.3f} (mean {np.mean(present_ms):.3f}, "
          f"max {np.max(present_ms):.3f}), loop {loop_ms:.3f}; alone: copy of a frame out of the pinned buffer "
          f"{copy_out_ms:.3f} ms of host time, interleave kernel {fmt_ms(interleave_ms)} ms of device time")


def runtime_path(scene, seed: int, window_ops: dict, kernel_ms: dict) -> dict:
    """The bench entry point in-process, then the Engine; returns the render
    kernels' launches on the bench run. Its stage_ms (the timed frames'
    stage marks) is printed beside window_ops (stage_device_ops, eager)
    and, for the kernel stages, beside kernel_ms (each render kernel's
    device ms in a graph replay)."""
    argv = ["--scene", "orbit", "--width", str(WIDTH), "--height", str(HEIGHT), "--frames", str(BENCH_FRAMES),
            "--warmup", str(BENCH_WARMUP), "--stages", "--seed", str(seed)]
    K.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    launches = dict(K.LAUNCHES)
    lines = out.getvalue().strip().splitlines()
    print(f"runtime path: python -m tpurast_torch.cli {' '.join(argv)} -> exit {rc} in "
          f"{time.perf_counter() - t0:.1f} s, launches {launches}")
    check(rc == 0 and len(lines) == 1, f"the bench exited {rc} with {len(lines)} lines")
    print(lines[0])
    res = json.loads(lines[0])
    check(res["parity_max_lsb"] is not None and res["parity_max_lsb"] <= 1, "the bench's parity gate")
    check(res["dropped_pairs"] == 0, f"the bench dropped {res['dropped_pairs']} pairs")
    check(res["backend"] == "cuda" and res["device"] == torch.cuda.get_device_name(0), "the bench's device")
    check(res["triangles"] == scene.n_faces and res["frames"] == BENCH_FRAMES, "the bench's scene")
    # Frames that reach each kernel: the gate's two kernel frames (the
    # capture's eager frame and the replay it compares), the warm-up, the
    # timed loop and the present loop. A capture launches nothing.
    loops = 2 + BENCH_WARMUP + BENCH_FRAMES + min(BENCH_FRAMES, cli.PRESENT_FRAMES)
    for name in KERNELS:
        want = loops if name in RENDER_KERNELS else 0
        check(launches[name] == want, f"runtime path: {name} launched {launches[name]} times, want {want}")
    check(list(res["stage_ms"]) == list(tracing.MARKS[1:]), "the bench's stage_ms keys")
    # The card's frame records and the host's count of frames agree (every
    # frame has finished: the present loop's last hand-out waited for it),
    # and the timed frames' marks add up to about their frame.
    marks = tracing.marks("cuda")
    last = int(tracing.snapshot().frames[str(marks.device)]["seq"][-1])
    check(last == marks.enqueued, f"the card's last frame record is {last}, the host counted {marks.enqueued}")
    marked = sum(res["stage_ms"].values())
    check(abs(marked - res["p50_frame_ms"]) < 0.25 * res["p50_frame_ms"],
          f"the stage marks sum to {marked:.3f} ms a frame, the frame takes {res['p50_frame_ms']:.3f}")
    check(res["capture_ms"] is not None and res["graph_pool_bytes"] > 0, "the bench's graph keys")
    copy_ms, nbytes = readback_ms(HEIGHT, WIDTH)
    print(f"present loop: {res['present_ms_per_frame']:.4f} ms a frame with the double-buffered read-back against "
          f"{res['p50_frame_ms']:.4f} ms a frame without ({res['present_ms_per_frame'] - res['p50_frame_ms']:+.4f}); "
          f"one read-back is {nbytes} B, {copy_ms:.4f} ms alone into pinned memory "
          f"({nbytes / copy_ms / 1e6:.2f} GB/s)")
    print("stage_ms (the timed frames' stage marks on the card's clock, in the replayed graph) ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in res["stage_ms"].items()))
    # The same stages' device ms from the eager stage_device_ops (a marked
    # interval also holds the launch gaps between its operations).
    pairs = {"geometry": ("geometry",), "binning": ("binning",), "raster": ("raster",), "pack": ("pack_attrs",),
             "shading": ("resolve", "plan", "sample"), "encode": ("encode",)}
    print("stage_ms vs stage_device_ops device ms: " + ", ".join(
        f"{k} {res['stage_ms'][k]:.3f} vs {sum(window_ops[o]['dev_ms'] for o in ops):.3f}" for k, ops in pairs.items()))
    kernel_stage_ms = {"raster": kernel_ms["raster"],
                       "shading": kernel_ms["resolve"] + kernel_ms["plan"] + kernel_ms["sample"]}
    print("stage_ms vs the kernels' device ms in a window replay: "
          + ", ".join(f"{k} {res['stage_ms'][k]:.3f} vs {v:.3f} ({res['stage_ms'][k] - v:+.3f})"
                      for k, v in kernel_stage_ms.items()))

    # The Presenter on CUDA frames whose shape changes between calls: each
    # pinned buffer is allocated anew, and every frame comes back as given.
    gen = microbench.generator(torch.device("cuda"), 5)
    shapes = [(4, 8, 16), (4, 8, 16), (4, 5, 7), (4, 8, 16), (4, 5, 7)]
    sent = [torch.randint(0, 256, sh, generator=gen, device="cuda", dtype=torch.uint8) for sh in shapes]
    presenter = Presenter()
    back = [presenter.present(f) for f in sent] + [presenter.flush()]
    check(back[0] is None and all(np.array_equal(b, f.permute(1, 2, 0).cpu().numpy())
                                  for b, f in zip(back[1:], sent)), "presenter: a frame came back changed")
    print(f"presenter: {len(sent)} CUDA frames of shapes {shapes} came back as given, one call late")

    # The Engine at its default target, started on the scene's camera track
    # (Engine.init's start lies in this scene's floor plane).
    eng = Engine(scene=scene, overlay=False)
    eng.camera = orbit_track(FRAMES)[0]
    start = eng.camera.position.copy()

    def controller(i):
        return MoveDirection(forward=True), (12.0 if i % 2 else -8.0, 3.0)

    images = [eng.tick(*controller(i)) for i in range(8)]
    final_camera = eng.camera
    tail = eng.presenter.flush()
    check(images[0] is None, "engine: the first tick handed out an image")
    for img in images[1:] + [tail]:
        check(img is not None and img.shape == (720, 1280, 4) and img.dtype == np.uint8, "engine: image shape")
    moved = float(np.linalg.norm(eng.camera.position - start))
    check(moved > 0 and eng.frame_index == 8, "engine: the camera did not move")
    check(eng.dropped_total == 0, f"engine: {eng.dropped_total} pairs dropped")
    want = eng.renderer.render_to_host(final_camera)
    same = bool(np.array_equal(tail, want))
    distinct = sum(not np.array_equal(a, b) for a, b in zip(images[1:], images[2:] + [tail]))
    print(f"engine: 8 ticks at {eng.renderer.width}x{eng.renderer.height}, p50 {eng.stats.p50_ms:.3f} ms a tick, camera "
          f"moved {moved:.4f}, window_miss_px {eng.window_miss_total}, {distinct} of 7 consecutive images differ; "
          f"last presented image equal to render_to_host of its camera {same}")
    check(same and distinct == 7, "engine: the read-back path did not return the frame it was given")
    return launches


def rss_gb() -> float | None:
    """This process' resident set (VmRSS of /proc/self/status) in GB, None
    where it cannot be read."""
    try:
        with open("/proc/self/status") as fh:
            return next(int(line.split()[1]) * 1024 / 1e9 for line in fh if line.startswith("VmRSS"))
    except (OSError, StopIteration):
        return None


class PeakRss:
    """The resident set before a block and its peak while the block runs,
    sampled every 2 ms by a thread (the host CPU's numpy work keeps its
    large allocations, so a sample sees them)."""

    def __enter__(self):
        self.before = self.peak = rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _take(self):
        v = rss_gb()
        if v is not None and (self.peak is None or v > self.peak):
            self.peak = v

    def _sample(self):
        while not self._stop.wait(0.002):
            self._take()

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._take()
        return False

    def __str__(self):
        if self.peak is None or self.before is None:
            return "peak host RSS not measured"
        return f"peak host RSS {self.peak:.3f} GB (from {self.before:.3f} GB before, +{self.peak - self.before:.3f})"


def decode_fixtures(card: str) -> None:
    """The committed zstd fixtures (tests/data/zstd, made with the zstandard
    package at levels 3 and 19: Huffman and FSE blocks, which a stored frame
    cannot show) through the port's decoder as this host's g++ built it,
    each against its SHA-256."""
    from tpurast_torch.assets import zstd

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "zstd")
    sums = dict(reversed(line.split()) for line in open(os.path.join(root, "SHA256SUMS")).read().splitlines())
    t0 = time.perf_counter()
    results = {}
    for name, digest in sorted(sums.items()):
        with open(os.path.join(root, name), "rb") as fh:
            frame = fh.read()
        out = zstd.decompress(frame, 1 << 20)
        results[name] = (len(frame), len(out), hashlib.sha256(out).hexdigest() == digest)
    print("zstd fixtures decoded by the port's decoder (g++ on this host): " + ", ".join(
        f"{k} {a} -> {b} B sha256 {'equal' if ok else 'DIFFERS'}" for k, (a, b, ok) in results.items())
        + f"; {(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")
    check(all(ok for _, _, ok in results.values()), "a zstd fixture decoded to other bytes")


def named_frame(label: str, r: Renderer, cam, card: str) -> dict:
    """r's frame of cam as a graph: the warm-up frame captures, two more
    replay; one launch of each kernel the path runs per frame, the replays
    equal to the eager frame bit for bit (bin_overflow too, printed: the
    bench's camera for the named scenes, the reference's, stands inside
    dragons64's grid, so dragons cut by the eye plane bin as full-screen
    faces past the huge-face budget, in either package); its costs
    (graph_costs). Returns the last frame, the launches counted over the
    two replays (from 0) and the costs."""
    r.render(cam)
    K.reset_launches()
    frames = [r.render(cam) for _ in range(2)]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_graph_frames(label, r, [cam, cam], frames)
    want = path_want(path_of(r), 2)
    check(all(launches[k] == want[k] for k in KERNELS), f"{label}: launches {launches}, want {want}")
    f = frames[-1]
    depth = f["depth"]
    check(bool(torch.isfinite(depth).all()), f"{label}: non-finite depth")
    cov = float((depth > 0).float().mean())
    check(cov > 0.005, f"{label}: coverage {cov:.4f}")
    costs = graph_costs(label, r, cam, card, reps=3)
    print(f"{label}: coverage {cov:.3f}, bin_overflow {int(f['bin_overflow'])}, window_miss_px "
          f"{int(f['window_miss_px'])}, launches for 2 replays {launches} [{card}]")
    return dict(frame=f, launches=launches, **costs)


def named_scenes(seed: int, card: str) -> dict:
    """The reference's data path on a stand-in data directory (phase 12).

    tpurast_torch.tools.standin_data writes the directory at full scale
    with stored zstd frames (this machine has no zstd package): the dragon's
    19,332 triangles, ten 2048^2 BC7 porsche textures, the crate's and the
    two BC6H textures, GLB meshes. It is not the reference's data. Then:
    the committed zstd fixtures decoded here (decode_fixtures); each of
    demo, porsche_class, hdr and dragons64 loaded through load_named_scene
    (the scene cache off) with its build seconds, peak host RSS, faces,
    texels, page and atlas bytes; the window graph frame at the config's
    size of cli.ALL_CONFIGS (3840x2160 for dragons64) with each render
    kernel against its plain version there (kernel_phases, guard bands
    included) and the frame's costs; for porsche_class the gather path
    with texture_dtype "auto" (srgb8 expected: the f16 rows pass 2 GiB;
    its rows are built on first read, their seconds and peak RSS are what
    every build paid before rows were built lazily) within 2 LSB of the
    window frame, and deferred equal to it bit for bit; for hdr the page
    above 1.0 and "auto" picking float16; then `python -m
    tpurast_torch.cli --all --data-dir` on the directory, its five lines
    marked as stand-ins; then entry(directory)'s fn(*args) against
    Renderer.render, bit for bit. Returns each render kernel's stats per
    scene."""
    from tpurast_torch.device.textures import SRGB8_ABOVE_F16_BYTES, resolve_texture_dtype
    from tpurast_torch.entry import EYE, TARGET, entry
    from tpurast_torch.entry import HEIGHT as ENTRY_H
    from tpurast_torch.entry import WIDTH as ENTRY_W
    from tpurast_torch.tools import standin_data

    t_phase = time.perf_counter()
    sizes = {label.rsplit("_", 1)[0]: (int(argv[3]), int(argv[5])) for argv, label in cli.ALL_CONFIGS}
    tmp = tempfile.mkdtemp(prefix="tpurast_torch_standin_")
    stats = {}
    try:
        t0 = time.perf_counter()
        record = standin_data.write_standin(tmp, "full", seed=seed, stored=True)
        print(f"named_scenes: stand-in data directory written in {time.perf_counter() - t0:.1f} s "
              f"({len(record['files'])} files, {sum(record['files'].values())} B, {record['supercompression']}, "
              f"seed {seed}): {record['note']}")
        decode_fixtures(card)

        for name in ("demo", "porsche_class", "hdr", "dragons64"):
            w, h = sizes[name]
            with PeakRss() as rss:
                t0 = time.perf_counter()
                scene = load_named_scene(name, tmp)
                build_s = time.perf_counter() - t0
            atlas = scene.atlas
            page = scene.pages.planes
            print(f"named_scenes {name} (stand-in): build {build_s:.2f} s, {rss} "
                  f"(quad rows built: {atlas.rows_built}); {scene.n_faces} faces, {len(scene.texture_uris)} textures, "
                  f"{int(page.shape[1]) * int(page.shape[2])} page texels ({page.shape[1]}x{page.shape[2]}, "
                  f"{page.size * 2} B as bf16), {atlas.texels_nbytes // (ROW_WIDTH * 4)} atlas rows "
                  f"({atlas.texels_nbytes} B as f32, {atlas.texels_nbytes // 2} B as f16) [{card}]")
            t0 = time.perf_counter()
            r = Renderer(scene, RendererConfig(width=w, height=h))
            torch.cuda.synchronize()
            print(f"named_scenes {name}: window Renderer {w}x{h} (upload {time.perf_counter() - t0:.2f} s), quad "
                  f"rows built: {atlas.rows_built}, texels uploaded: {'texels' in r.scene['atlas']}")
            check(not atlas.rows_built and "texels" not in r.scene["atlas"], f"{name}: the window path built rows")
            cam = cli.flythrough(name, 1)[0]
            stats[name] = kernel_phases(r, cam, card, phase=f"named_scenes {name}")
            win = named_frame(f"named_scenes {name} window {w}x{h}", r, cam, card)
            for k in RENDER_KERNELS:
                stats[name][k]["launches"] = win["launches"][k]
            print(f"named_scenes {name} {w}x{h}: frame {win['graph_ms']:.3f} ms (graph), device busy "
                  f"{fmt_ms(win['busy_ms'])} ms, idle share "
                  f"{'not measured' if win['idle'] is None else format(win['idle'], '.3f')}, bin_overflow "
                  f"{int(win['frame']['bin_overflow'])}, pairs {stats[name]['raster']['pairs']}, densest tile "
                  f"{stats[name]['raster']['densest']} pairs [{card}]")

            if name == "porsche_class":
                want_dtype = resolve_texture_dtype(scene, "auto")
                check(not atlas.rows_built, "resolve_texture_dtype built the rows")
                with PeakRss() as rows_rss:
                    t0 = time.perf_counter()
                    atlas.texels  # noqa: B018  (the first read builds the rows)
                    rows_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                rg = Renderer(scene, RendererConfig(width=w, height=h, sampler="gather", texture_dtype="auto"))
                torch.cuda.synchronize()
                up_s = time.perf_counter() - t0
                tex = rg.scene["atlas"]["texels"]
                print(f"named_scenes porsche_class gather: texture_dtype auto -> {rg.texture_dtype} (f16 rows "
                      f"{atlas.texels_nbytes // 2} B against the {SRGB8_ABOVE_F16_BYTES} B threshold, max texel "
                      f"{atlas.max_value():.4f}); the quad rows built on first read in {rows_s:.2f} s, {rows_rss}; "
                      f"converted on the card and uploaded in {up_s:.2f} s: texels {tuple(tex.shape)} {tex.dtype} "
                      f"({tex.numel() * tex.element_size()} B on the card). Every build of this scene paid those "
                      f"rows before they were built on first read: {build_s:.2f} + {rows_s:.2f} s [{card}]")
                check(rg.texture_dtype == want_dtype == "srgb8", f"porsche_class: auto chose {rg.texture_dtype}")
                # Both shade kernels on the srgb8 rows against their plain versions.
                kph = "named_scenes porsche_class shade kernels"
                fi = frame_inputs(rg, cam)
                fmt, ma, light = rg._frame_kwargs["texture_format"], rg.config.max_anisotropy, light_kwargs(
                    rg._frame_kwargs)
                lut = rg.scene["atlas"]["srgb_lut"]
                sp = shade_pair(kph, fi["vis"], fi["attrs"], fi["rows"], tex, fmt, lut, fi["cp"], ma, light)
                shade_stats = shade_times(sp, tex, fmt, lut, fi["cp"], ma, light, fi["rows"])
                print(f"{kph} ({fmt} rows, anisotropy {ma}): " + "; ".join(
                    f"{k} vs plain: {fmt_compare(c)}" for k, c in sp["cmp"].items())
                    + f"; deferred equal to gather on the resolve kernel's G-buffer {sp['same']}; "
                    + "; ".join(fmt_times(k, shade_stats[k]) for k in SHADE_KERNELS) + f" [{card}]")
                print_guards(kph, card)
                del fi, sp
                gnf = named_frame(f"named_scenes porsche_class gather {w}x{h}", rg, cam, card)
                rd = Renderer(scene, RendererConfig(width=w, height=h, shading="deferred", texture_dtype="auto"))
                dnf = named_frame(f"named_scenes porsche_class deferred {w}x{h}", rd, cam, card)
                gather, deferred = gnf["frame"], dnf["frame"]
                shade_stats["gather"]["launches"] = gnf["launches"]["gather"]
                shade_stats["deferred"]["launches"] = dnf["launches"]["deferred"]
                stats[name].update(shade_stats)
                gw = (gather["color"].int() - win["frame"]["color"].int()).abs()
                dg = (deferred["color"].int() - gather["color"].int()).abs()
                same_depth = bool(torch.equal(gather["depth"], win["frame"]["depth"]))
                print(f"named_scenes porsche_class: gather vs window max {int(gw.max())} LSB "
                      f"({int((gw.amax(dim=0) > 0).sum())} px above 0, {int((gw.amax(dim=0) > 1).sum())} above 1), "
                      f"depth equal {same_depth}; deferred vs gather max {int(dg.max())} LSB, depth equal "
                      f"{bool(torch.equal(deferred['depth'], gather['depth']))} [{card}]")
                check(int(gw.max()) <= 2 and same_depth, "porsche_class: gather is more than 2 LSB from window")
                check(int(dg.max()) == 0 and bool(torch.equal(deferred["depth"], gather["depth"])),
                      "porsche_class: deferred differs from forward + gather")
                del rg, rd, gather, deferred, gnf, dnf
            if name == "hdr":
                page_max = float(r.scene["atlas"]["page"].float().max())
                auto = resolve_texture_dtype(scene, "auto")
                print(f"named_scenes hdr: page max {page_max} (bf16), atlas max texel {atlas.max_value()}, "
                      f"texture_dtype auto -> {auto}")
                check(page_max > 1.0 and auto == "float16", "hdr: no texel above 1.0, or auto did not pick float16")
            del r, scene, win
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tpurast_torch.cli", "--all", "--data-dir", tmp, "--frames", "64"],
                              capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
                              timeout=900)
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        for line in lines:
            print(f"bench line (stand-in data directory, not the reference's data): {json.dumps(line)}")
        print(f"cli --all on the stand-in: exit {proc.returncode}, {len(lines)} lines, "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        check(proc.returncode == 0 and len(lines) == len(cli.ALL_CONFIGS),
              f"cli --all: exit {proc.returncode}:\n{proc.stderr[-3000:]}")
        check(all(x["parity_max_lsb"] <= 1 and x["backend"] == "cuda" for x in lines),
              "cli --all: a line failed its parity gate or ran off the card")

        fn, args = entry(tmp)
        K.reset_launches()
        outs = [fn(*args), fn(*args)]  # the first renders eagerly and captures, the second replays
        launches = dict(K.LAUNCHES)
        dragon = build_scene([load_glb(os.path.join(tmp, "meshes", "stanford_dragon.glb"))], data_dir=tmp)
        want = Renderer(dragon, RendererConfig(width=ENTRY_W, height=ENTRY_H)).render(
            Camera.from_target(list(EYE), list(TARGET)))
        same = [all(bool(torch.equal(o[k], want[k])) for k in GRAPH_OUTPUTS) for o in outs]
        cov = float((outs[1]["depth"] > 0).float().mean())
        print(f"entry(stand-in): fn is a {type(fn).__name__}; fn(*args) equal to Renderer.render bit for bit "
              f"{same} (eager + capture, replay), coverage {cov:.3f}, launches {launches} [{card}]")
        check(isinstance(fn, FrameGraph) and all(same), "entry's frame differs from Renderer.render")
        check(all(launches[k] == 2 for k in RENDER_KERNELS), "entry: not one launch per kernel a frame")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"named_scenes: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return stats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sanitize-cases", action="store_true",
                    help="run only the case set that the normal run hands to compute-sanitizer")
    ap.add_argument("--multi-device", action="store_true",
                    help="run only the multi_device phase (for a machine with several cards)")
    ap.add_argument("--named-scenes", action="store_true", help="run only the named_scenes phase")
    ap.add_argument("--config-matrix", action="store_true", help="run only kernel_phases and config_matrix")
    ap.add_argument("--shade-kernels", action="store_true", help="run only the shade_kernels phase")
    args = ap.parse_args()
    t_run = time.perf_counter()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    os.environ.setdefault("TPURAST_TORCH_SCENE_CACHE", "0")
    if args.sanitize_cases:
        sanitize_cases(args.seed)
        return
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    path, seconds, log = _build.build()
    print(f"build: {path.name} in {seconds:.1f} s")
    for line in log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "error")):
            print("  nvcc:", line.strip())
    _build.library()
    for name in ("raster", "plan", "plan_large", "sample", "vmem_take"):
        regs, blocks = _build.kernel_info(name)
        print(f"{name} kernel: {regs} registers per thread, {blocks} resident blocks per SM")
    print_shade_info()
    sms, hz, src = sm_clock()
    print(f"card: {sms} SMs, SM clock {hz / 1e9:.3f} GHz ({src})")

    card = smi.stdout.strip()
    if args.named_scenes:
        named_scenes(args.seed, card)
        return
    t0 = time.perf_counter()
    scene = load_named_scene("orbit", seed=args.seed)
    cams = orbit_track(FRAMES)
    cfg = RendererConfig(width=WIDTH, height=HEIGHT)
    r = Renderer(scene, cfg)  # on the card: the default device
    torch.cuda.synchronize()
    print(f"scene: {scene.n_faces} triangles, {len(scene.texture_uris)} textures, page "
          f"{tuple(r.scene['atlas']['page'].shape)} bf16; build + upload {time.perf_counter() - t0:.1f} s")

    if args.multi_device:
        deferred = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT, shading="deferred"))
        gather = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT, sampler="gather"))
        multi_device({"window": r, "gather": gather, "deferred": deferred}, cams[0], card)
        return
    if args.shade_kernels:
        shade_kernels(scene, r, cams[0], card)
        return
    stats = kernel_phases(r, cams[0], card)
    stats.update(shade_kernels(scene, r, cams[0], card))
    config_matrix(scene, cams[0], card, args.seed)
    if args.config_matrix:
        return
    stats.update(probe_phases(torch.device("cuda"), card))
    window_stages = stage_breakdown(r, cams[0])
    window_ops = stage_device_ops(r, cams[0])
    print_stages("window", window_stages)
    print_stage_ops("window", window_stages, window_ops)

    # Window main path: a warm-up frame (it captures the Renderer's CUDA
    # graph), then the track (graph replays), with counters from zero.
    K.reset_launches()
    frames, times = run_track(r, cams)
    launches = dict(K.LAUNCHES)
    n_rendered = FRAMES + 1
    print(f"main path: {n_rendered} frames (1 warm-up), launches {launches}")
    print_times("window", times, r, cams[0])
    for name in KERNELS:
        want = n_rendered if name in RENDER_KERNELS else 0
        check(launches[name] == want, f"{name}: {launches[name]} launches for {n_rendered} frames, want {want}")
    check_frames(frames, "window")
    print("coverage per frame: " + ", ".join(f"{float((f['depth'] > 0).float().mean()):.3f}" for f in frames))
    print("window_miss_px per frame (pixels of residual tiles, sampled straight from the page): "
          + ", ".join(str(int(f["window_miss_px"])) for f in frames))

    replay_kernel_ms = graph_frames(r, cams, frames, card)

    # Inside plain_kernels() the Renderer renders eagerly with the plain
    # versions: no kernel launches, and no graph replays.
    K.reset_launches()
    with K.plain_kernels():
        plain = r.render(cams[0])
    torch.cuda.synchronize()
    plain_launches = sum(K.LAUNCHES.values())
    lsb = int((plain["color"].int() - frames[0]["color"].int()).abs().max())
    d_eq = bool(torch.equal(plain["depth"], frames[0]["depth"]))
    miss_eq = int(plain["window_miss_px"]) == int(frames[0]["window_miss_px"])
    print(f"frame 0, graph frame vs plain versions (eager, {plain_launches} kernel launches): color max LSB diff "
          f"{lsb}, depth equal {d_eq}, window_miss_px equal {miss_eq}")
    check(plain_launches == 0, "a kernel launched inside plain_kernels()")
    check(lsb <= 1 and d_eq and miss_eq, "full frame disagrees with the plain versions")

    # Microbenchmark path: the tools' entry points, probe counters from zero.
    K.reset_launches()
    take = microbench.vmemtake(torch.device("cuda"))
    pipe = microbench_pipeline.run(torch.device("cuda"))
    for name in PROBE_KERNELS:
        launches[name] = K.LAUNCHES[name]
        check(launches[name] > 0, f"{name}: not launched on the microbenchmark path")
    check(all(K.LAUNCHES[name] == 0 for name in RENDER_KERNELS), "a render kernel launched on the microbench path")
    print(f"microbench path: launches {dict(K.LAUNCHES)}; vmemtake {take['ms']:.4f} ms "
          f"({take['ns_per_row']:.4f} ns/row); pipeline " + json.dumps({k: round(v, 4) for k, v in pipe.items()}))

    paths = gather_paths(scene, cams, frames, card)
    for name in SHADE_KERNELS:  # each on its own path's track, the counts from zero around it
        launches[name] = paths[name][2][name]
    slab_kernels(r, cams[0], card)
    slabs = slab_frames({"window": r, "gather": paths["gather"][0], "deferred": paths["deferred"][0]}, cams[0], card)
    mesh = multi_device({"window": r, "gather": paths["gather"][0], "deferred": paths["deferred"][0]}, cams[0], card)
    del paths
    # slab_launches and mesh_launches: a kernel's own path (the window path
    # for raster and resolve: 8 slabs, the mesh's window replay).
    home = {name: "window" if name not in SHADE_KERNELS else name for name in KERNELS}
    slab_launches = {name: slabs[home[name]][name] for name in KERNELS}
    mesh_launches = {name: mesh[home[name]][name] for name in KERNELS}
    scan_launches = scan_path(scene, r, cams, frames, card)
    runtime_launches = runtime_path(scene, args.seed, window_ops, replay_kernel_ms)
    present_breakdown(r, cams)
    tool_phase(scene, args.seed, card)
    pose_launches = pose_tools(scene, r, card)
    named = named_scenes(args.seed, card)
    print(f"guard bands: {len(GUARDS)} guarded launches over "
          f"{sorted({k.split()[0] for _, k, _ in GUARDS})} in {len({p for p, _, _ in GUARDS})} phases, every band "
          f"intact {all(g['intact'] for _, _, g in GUARDS)} [{card}]")
    sanitizer_s = sanitizer_phase(args.seed, card)
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s, of it the sanitizer phase {sanitizer_s:.1f} s [{card}]")

    print("device ms per call (torch.profiler), kernel vs plain: " + "; ".join(
        f"{name} {fmt_ms(stats[name]['dev_ms'])} vs {fmt_ms(stats[name]['plain_dev_ms'])}" for name in KERNELS))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    report = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "runtime_launches": runtime_launches[name], "slab_launches": slab_launches[name],
         "mesh_launches": mesh_launches[name], "scan_launches": scan_launches[name],
         "pose_launches": pose_launches[name],
         **({"named_scenes": {s: {k: named[s][name][k] for k in ("launches", "max_abs_err", "ms", "dev_ms", "bound_ms",
                                                                    "bound_by")} for s in named if name in named[s]}}
            if name in RENDER_KERNELS + SHADE_KERNELS else {}),
         **{k: stats[name][k] for k in keys}}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": report}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
