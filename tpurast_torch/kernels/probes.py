"""Device probes of the microbenchmarks: row sums of an on-chip table, and
a scaled G-buffer plane copy under three launch geometries.

Replace the Pallas kernels of the reference's tools: vmem_take that of
tools/microbench.py cmd_vmemtake (call :262), plane_scale the three of
tools/microbench_pipeline.py main (calls :35, :63, :89). The CUDA kernels
are csrc/probes.cu; the plain torch versions below compute the same bits
and are what CPU tensors take. tpurast_torch/tools drives both.
"""

from __future__ import annotations

import torch

from tpurast_torch import kernels as _k
from tpurast_torch.kernels import _build

#: Table width and the most rows csrc/probes.cu stages (two halves of
#: 2048 rows fit the shared memory of one block).
TAKE_WIDTH = 16
MAX_TAKE_ROWS = 4096


def vmem_take_plain(table, idx) -> torch.Tensor:
    """out[i] = sum_j table[idx[i], j], the columns added left to right (as
    the kernel adds them); idx is clamped into the table (JAX's gather)."""
    rows = table[torch.clamp(idx.long(), 0, table.shape[0] - 1)]
    acc = rows[:, 0]
    for j in range(1, table.shape[1]):
        acc = acc + rows[:, j]
    return acc


def vmem_take(table, idx) -> torch.Tensor:
    """Row sums of table (R, 16) f32, R <= 4096, at idx (N,) int32:
    (N,) f32. CPU tensors run the plain version; CUDA tensors launch
    csrc/probes.cu vmem_take, which holds the table in shared memory."""
    if not _k.use_kernel(table, idx):
        return vmem_take_plain(table, idx)
    _k.check(table, "table", torch.float32)
    if table.dim() != 2 or table.shape[1] != TAKE_WIDTH or not 1 <= table.shape[0] <= MAX_TAKE_ROWS:
        raise ValueError(f"table: expected (R, {TAKE_WIDTH}) with 1 <= R <= {MAX_TAKE_ROWS}, "
                         f"got {tuple(table.shape)}")
    _k.check(idx, "idx", torch.int32)
    if idx.dim() != 1:
        raise ValueError(f"idx: expected (N,), got {tuple(idx.shape)}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    _build.call("tr_vmem_take", table, table.shape[0], idx, idx.numel(), out)
    _k.LAUNCHES["vmem_take"] += 1
    return out


def plane_scale_plain(gbuf, plane: int, *, block_h: int, block_w: int, threads: int = 0) -> torch.Tensor:
    """2 * gbuf[plane] as (1, H, W); the block geometry does not change
    the result."""
    del block_h, block_w, threads
    return 2.0 * gbuf[plane : plane + 1]


def plane_scale(gbuf, plane: int, *, block_h: int, block_w: int, threads: int = 0) -> torch.Tensor:
    """2 * gbuf[plane] of a (P, H, W) f32 G-buffer as (1, H, W), one CUDA
    block per (block_h, block_w) rectangle of about ``threads`` threads
    (32-1024; 0 takes the kernel's default). CPU tensors run the plain
    version; CUDA tensors launch csrc/probes.cu plane_scale."""
    if not _k.use_kernel(gbuf):
        return plane_scale_plain(gbuf, plane, block_h=block_h, block_w=block_w)
    _k.check(gbuf, "gbuf", torch.float32)
    if gbuf.dim() != 3 or 0 in gbuf.shape:
        raise ValueError(f"gbuf: expected a non-empty (P, H, W), got {tuple(gbuf.shape)}")
    if not 0 <= plane < gbuf.shape[0]:
        raise ValueError(f"plane {plane} outside [0, {gbuf.shape[0]})")
    if block_h < 1 or block_w < 1:
        raise ValueError(f"block must be at least 1x1, got {block_h}x{block_w}")
    if threads != 0 and not 32 <= threads <= 1024:
        raise ValueError(f"threads must be 0 or in [32, 1024], got {threads}")
    _, h, w = gbuf.shape
    out = torch.empty((1, h, w), dtype=torch.float32, device=gbuf.device)
    _build.call("tr_plane_scale", gbuf, plane, h, w, block_h, block_w, threads, out)
    _k.LAUNCHES["plane_scale"] += 1
    return out
