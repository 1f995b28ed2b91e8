"""Device microbenchmarks that size the kernel and layout decisions.

Counterpart of tools/microbench.py, its seven subcommands with the same
arguments and printed quantities, on an NVIDIA GPU, and planescale, which
chooses the plane_scale kernel's block size:

  gather     ns/row vs row width/dtype + index locality + 2x-gather cost
  tablesize  ns/row vs table footprint
  surface    ns/row over a (rows x width) grid (row count vs width bound)
  sort       stable sort of int32 tile keys + payload (pair-sort binning)
  scatter    scatter-write cost (pair expansion alternative)
  shade      shade_gbuffer: the kernel (csrc/shade.cu) beside its torch
             decomposition (gather vs trilerp vs the whole plain version)
  vmemtake   row sums of an on-chip table (CUDA kernel vmem_take)
  planescale the plane_scale kernel's three launch geometries at 128-1024
             threads per block, beside torch.mul (device time too)

Run: python -m tpurast_torch.tools.microbench <subcommand>

Times are CUDA events around n calls after one warm-up call (cuda_ms);
planescale adds device time (device_ms, torch.profiler). Without a CUDA
device the command fails. Random indices and values come
from a seeded torch.Generator on the device. Each subcommand's work is a
function of the device and the sizes that returns its measurements, so
chip_smoke.py and the tests can call it; ``timer`` is how a function
times a callable (cuda_ms unless a caller passes another).
"""

from __future__ import annotations

import argparse
import sys

import torch

from tpurast_torch.config import RendererConfig
from tpurast_torch.kernels import probes
from tpurast_torch.kernels import shade as kshade

N_PX = 2_073_600  # 1080p pixel count: the per-frame gather row count

GATHER_CASES = [
    (torch.float16, 52), (torch.float16, 16), (torch.float16, 8),
    (torch.float16, 4), (torch.float32, 16), (torch.float32, 4),
]
TABLE_MB = (0.125, 0.5, 2, 8, 32, 128, 512)
SURFACE_WIDTHS = (16, 52, 164, 328, 656)
SURFACE_ROWS = tuple(1 << e for e in (17, 18, 19, 20, 22))
SORT_SIZES = tuple(1 << e for e in (16, 18, 20, 22))
SCALE_THREADS = (128, 256, 512, 1024)


def cuda_ms(fn, n: int = 20) -> float:
    """Mean milliseconds per call of fn over n calls, by CUDA events on
    the current stream, after one warm-up call."""
    if not torch.cuda.is_available():
        raise RuntimeError("microbench timings need a CUDA device")
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, n: int = 20) -> float | None:
    """Device milliseconds per call of fn: the time torch.profiler records
    in CUDA kernels (and copies) over n calls after one warm-up call, per
    call; host time between launches is left out. torch.profiler now and
    then drops a launch's record, so each operation counts its mean
    recorded time once for each launch a call makes (its records over n,
    rounded up) rather than its total over n. None when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total / e.count * -(-e.count // n) for e in ops)
    return total_us / 1e3 if total_us > 0 else None


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def randint(high: int, n: int, device, seed: int) -> torch.Tensor:
    """(n,) int32 uniform in [0, high) from a seeded generator on device."""
    return torch.randint(0, high, (n,), generator=generator(device, seed), device=device, dtype=torch.int32)


def gather_sum(table, idx) -> torch.Tensor:
    """One row gather, upcast and summed per row (the probe every gather
    subcommand times)."""
    return table[idx].to(torch.float32).sum(dim=-1)


def gather(device, *, mb: float = 512, n_px: int = N_PX, timer=cuda_ms) -> dict:
    """ns/row of one and two row gathers per (dtype, width) over an mb-MB
    table, and the f16 w=16 gather with sorted, local and random indices."""
    cases = []
    for dtype, width in GATHER_CASES:
        bytes_per = width * torch.tensor([], dtype=dtype).element_size()
        rows = int(mb * 2**20) // bytes_per
        table = torch.zeros((rows, width), dtype=dtype, device=device)
        idx = randint(rows, n_px, device, 0)
        idx2 = randint(rows, n_px, device, 1)
        ms1 = timer(lambda: gather_sum(table, idx))
        ms2 = timer(lambda: gather_sum(table, idx) + gather_sum(table, idx2))
        cases.append({"dtype": str(dtype).removeprefix("torch."), "width": width, "bytes_per_row": bytes_per,
                      "ms_1x": ms1, "ns_per_row": ms1 * 1e6 / n_px, "ms_2x": ms2})
        del table
    rows = int(mb * 2**20) // 32
    table = torch.zeros((rows, 16), dtype=torch.float16, device=device)
    idx_r = randint(rows, n_px, device, 0)
    idx_s = torch.sort(idx_r).values
    idx_l = torch.clamp(
        torch.arange(n_px, device=device) // 4 + randint(64, n_px, device, 0), 0, rows - 1
    ).to(torch.int32)
    locality = {name: timer(lambda i=i: gather_sum(table, i))
                for name, i in (("sorted", idx_s), ("local", idx_l), ("random", idx_r))}
    return {"n_px": n_px, "mb": mb, "cases": cases, "locality_ms": locality}


def tablesize(device, *, sizes_mb=TABLE_MB, big_mb: float = 512, n_px: int = N_PX, timer=cuda_ms) -> dict:
    """ns/row of the f16 w=16 (32 B/row) gather against the table size, and
    a big table read only in its first 128 KB."""
    rows_out = []
    for mb in sizes_mb:
        rows = int(mb * 2**20 / 32)
        table = torch.zeros((rows, 16), dtype=torch.float16, device=device)
        idx = randint(rows, n_px, device, 0)
        ms = timer(lambda: gather_sum(table, idx))
        rows_out.append({"mb": mb, "rows": rows, "ms": ms, "ns_per_row": ms * 1e6 / n_px})
        del table
    table = torch.zeros((int(big_mb * 2**20 / 32), 16), dtype=torch.float16, device=device)
    idx_sm = randint(min(4096, table.shape[0]), n_px, device, 0)
    return {"n_px": n_px, "sizes": rows_out, "big_mb": big_mb,
            "big_first_128kb_ms": timer(lambda: gather_sum(table, idx_sm))}


def surface(device, *, rows_list=SURFACE_ROWS, widths=SURFACE_WIDTHS, max_mb: float = 4096, n_px: int = N_PX,
            timer=cuda_ms) -> dict:
    """ns/row of the f16 gather over (rows x width); None where the table
    would exceed max_mb."""
    grid = []
    for rows in rows_list:
        line = []
        for width in widths:
            if rows * width * 2 / 2**20 > max_mb:
                line.append(None)
                continue
            table = torch.zeros((rows, width), dtype=torch.float16, device=device)
            idx = randint(rows, n_px, device, 0)
            line.append(timer(lambda: gather_sum(table, idx), 15) * 1e6 / n_px)
            del table
        grid.append(line)
    return {"n_px": n_px, "rows": list(rows_list), "widths": list(widths), "ns_per_row": grid}


def sort_pairs(keys, vals):
    """(keys, vals) sorted by key then value. vals ascend within each key
    (they are an arange), so a stable sort by key gives the order of the
    reference's lax.sort((k, v), num_keys=2)."""
    sk, order = torch.sort(keys, stable=True)
    return sk, vals[order]


def sort(device, *, sizes=SORT_SIZES, timer=cuda_ms) -> dict:
    """Milliseconds to sort P int32 tile keys (2048 tiles) with an int32
    payload."""
    rows = []
    for p in sizes:
        keys = randint(2048, p, device, 0)
        vals = torch.arange(p, dtype=torch.int32, device=device)
        rows.append({"p": p, "ms": timer(lambda: sort_pairs(keys, vals), 10)})
    return {"sizes": rows}


def scatter_set(dest, src, cap: int) -> torch.Tensor:
    """buf[dest] = src into a (cap + 1,) zero buffer (indices are in
    [0, cap), so the reference's mode="drop" drops nothing)."""
    buf = torch.zeros(cap + 1, dtype=torch.int32, device=dest.device)
    buf[dest.reshape(-1).long()] = src.reshape(-1)
    return buf


def scatter(device, *, faces: int = 1 << 21, timer=cuda_ms) -> dict:
    """Milliseconds to scatter faces x 8 slots into a 2*faces buffer."""
    tpf = 8
    cap = faces * 2
    dest = randint(cap, faces * tpf, device, 0).reshape(faces, tpf)
    src = torch.arange(faces, dtype=torch.int32, device=device)[:, None].expand(faces, tpf)
    return {"faces": faces, "tpf": tpf, "cap": cap, "ms": timer(lambda: scatter_set(dest, src, cap), 10)}


def shade_inputs(device, *, height: int = 1088, width: int = 1920):
    """The reference's synthetic G-buffer: uniform planes, then mip-0
    offset 0, a 512^2 own mip, a 256^2 parent mip, every pixel matched;
    and a camera at the origin."""
    gb = torch.rand((24, height, width), generator=generator(device, 0), device=device)
    gb[8] = 0.0
    gb[9] = 512.0
    gb[10] = 512.0
    gb[11] = 256.0
    gb[12] = 256.0
    gb[16] = 1.0
    return gb, torch.zeros(3, dtype=torch.float32, device=device)


def gather_only(gb, texels) -> torch.Tensor:
    """One atlas row per pixel at the G-buffer's u, v on a 512-wide mip,
    summed (the gather half of _trilerp alone)."""
    u, v = gb[6], gb[7]
    tw0 = gb[9].to(torch.int32)
    th0 = gb[10].to(torch.int32)
    off0 = gb[8].to(torch.int32) * 256
    x0i = torch.remainder((u * 512 - 0.5).to(torch.int32), tw0)
    y0i = torch.remainder((v * 512 - 0.5).to(torch.int32), th0)
    idx = torch.clamp(off0 + y0i * tw0 + x0i, 0, texels.shape[0] - 1)
    return texels[idx.long()].to(torch.float32).sum(dim=-1)


def trilerp_only(gb, texels) -> torch.Tensor:
    """_trilerp at the G-buffer's fields, its 4 planes summed."""
    off0 = gb[8].to(torch.int32) * 256
    out = kshade._trilerp(texels, off0, gb[9].to(torch.int32), gb[10].to(torch.int32), gb[11].to(torch.int32),
                         gb[12].to(torch.int32), gb[13], gb[6], gb[7])
    return out[0] + out[1] + out[2] + out[3]


def shade(texels, device, *, height: int = 1088, width: int = 1920, timer=cuda_ms) -> dict:
    """shade_gbuffer on the synthetic G-buffer (trilinear, the
    RendererConfig lighting): the wrapper (the kernel on a card), its plain
    torch version, and the plain version's gather and trilerp alone, over
    the (N, 52) atlas rows texels."""
    cfg = RendererConfig(width=1920, height=1080)
    gb, cam = shade_inputs(device, height=height, width=width)
    kw = dict(light_direction=cfg.light_direction, light_color=cfg.light_color,
              ambient_amount=cfg.ambient_amount, specular_power=cfg.specular_power,
              clear_color=cfg.clear_color)
    return {
        "atlas_shape": tuple(texels.shape),
        "atlas_dtype": str(texels.dtype).removeprefix("torch."),
        "atlas_mb": texels.numel() * texels.element_size() / 1e6,
        "kernel_ms": timer(lambda: kshade.shade_gbuffer(gb, texels, cam, **kw)),
        "full_ms": timer(lambda: kshade.shade_gbuffer_plain(gb, texels, cam, **kw)),
        "gather_only_ms": timer(lambda: gather_only(gb, texels)),
        "trilerp_only_ms": timer(lambda: trilerp_only(gb, texels)),
    }


def vmemtake(device, *, rows: int = 4096, n_px: int = N_PX, timer=cuda_ms) -> dict:
    """Milliseconds of the on-chip table row-sum kernel (kernels/probes.py
    vmem_take) over n_px indices into a rows x 16 f32 table."""
    width = probes.TAKE_WIDTH
    table = torch.rand((rows, width), generator=generator(device, 1), device=device)
    idx = randint(rows, n_px, device, 0)
    ms = timer(lambda: probes.vmem_take(table, idx))
    return {"rows": rows, "width": width, "n_px": n_px, "ms": ms, "ns_per_row": ms * 1e6 / n_px}


def planescale(device, *, tiles_x: int = 15, tiles_y: int = 34, threads=SCALE_THREADS, n: int = 50,
               timer=cuda_ms, dev_timer=device_ms) -> dict:
    """ms per call of the plane_scale kernel (kernels/probes.py) in
    microbench_pipeline's three launch geometries over a (24, 32 tiles_y,
    128 tiles_x) G-buffer, at each block size in threads, by CUDA events
    (timer) and device time (dev_timer); beside torch.mul(src[plane], 2),
    the one PyTorch call for the same, timed alike before and after the
    sweep. n repeated calls, so the plane's bytes come from L2 after the
    first. Raises if an output is not exactly 2 * gbuf[16]."""
    h, w = 32 * tiles_y, 128 * tiles_x
    gbuf = torch.rand((24, h, w), generator=generator(device, 0), device=device)
    one = gbuf[16:17].clone()
    want = 2.0 * gbuf[16:17]
    geoms = {"tile-grid": (gbuf, 16, 32, 128), "one-plane": (one, 0, 32, 128), "row-band": (gbuf, 16, 32, w)}
    rows = []
    for label, (src, plane, bh, bw) in geoms.items():
        def lib():
            return torch.mul(src[plane], 2)

        row = {"geometry": label, "torch_mul_ms": [timer(lib, n)], "torch_mul_dev_ms": [dev_timer(lib, n)],
               "threads": {}}
        for t in threads:
            def fn():
                return probes.plane_scale(src, plane, block_h=bh, block_w=bw, threads=t)

            if not torch.equal(fn(), want):
                raise AssertionError(f"plane_scale {label}, {t} threads: output differs from 2 * gbuf[16]")
            row["threads"][t] = {"ms": timer(fn, n), "dev_ms": dev_timer(fn, n)}
        row["torch_mul_ms"].append(timer(lib, n))
        row["torch_mul_dev_ms"].append(dev_timer(lib, n))
        rows.append(row)
    return {"height": h, "width": w, "n": n, "geometries": rows}


# -- command line -------------------------------------------------------------


def cmd_gather(args, dev):
    res = gather(dev, mb=args.mb)
    print(f"--- gather: {N_PX / 1e6:.2f}M rows, atlas {args.mb} MB ---")
    for c in res["cases"]:
        print(f"{c['dtype']} w={c['width']:2d} ({c['bytes_per_row']:3d} B/row): "
              f"1x gather {c['ms_1x']:7.2f} ms ({c['ns_per_row']:5.2f} ns/row), "
              f"2x gather {c['ms_2x']:7.2f} ms", flush=True)
    loc = res["locality_ms"]
    print(f"f16 w=16 sorted idx: {loc['sorted']:7.2f} ms | local idx: {loc['local']:7.2f} ms | "
          f"random: {loc['random']:7.2f} ms", flush=True)


def cmd_tablesize(args, dev):
    res = tablesize(dev)
    print("--- f16 w=16 (32 B/row) gather, 2.07M rows, vs table size ---")
    for r in res["sizes"]:
        print(f"table {r['mb']:7.3f} MB ({r['rows']:>9,} rows): {r['ms']:7.2f} ms "
              f"({r['ns_per_row']:5.2f} ns/row)", flush=True)
    print(f"512MB table, idx in first 128KB: {res['big_first_128kb_ms']:7.2f} ms", flush=True)


def cmd_surface(args, dev):
    res = surface(dev)
    print(f"{'rows':>10} | " + " | ".join(f"w={w:<4}" for w in res["widths"]))
    for rows, line in zip(res["rows"], res["ns_per_row"]):
        cells = ["  -  " if ns is None else f"{ns:5.2f}" for ns in line]
        print(" | ".join([f"{rows:>10,}"] + cells), flush=True)


def cmd_sort(args, dev):
    print("--- stable sort int32 (tile keys) + payload ---")
    for r in sort(dev)["sizes"]:
        print(f"P={r['p']:>9,}: {r['ms']:8.2f} ms", flush=True)


def cmd_scatter(args, dev):
    print("--- scatter (pair expansion) ---")
    r = scatter(dev)
    print(f"F={r['faces']:,} x {r['tpf']} slots -> {r['cap']:,} buf: {r['ms']:8.2f} ms", flush=True)


def cmd_shade(args, dev):
    from tpurast_torch.device.scene import load_demo_scene
    from tpurast_torch.device.textures import upload_atlas

    texels = upload_atlas(load_demo_scene(args.data_dir).atlas, "float16", dev)["texels"]
    r = shade(texels, dev)
    print(f"atlas: {r['atlas_shape']} {r['atlas_dtype']} = {r['atlas_mb']:.1f} MB")
    print(f"shade_gbuffer kernel: {r['kernel_ms']:7.3f} ms")
    print(f"full shade_gbuffer (plain torch): {r['full_ms']:7.2f} ms")
    print(f"gather-only (1 row/px): {r['gather_only_ms']:7.2f} ms")
    print(f"trilerp-only: {r['trilerp_only_ms']:7.2f} ms")


def cmd_vmemtake(args, dev):
    print("--- CUDA on-chip table row-sum probe (vmem_take) ---")
    r = vmemtake(dev)
    print(f"vmem take ({r['rows']}x{r['width']} f32 table): {r['ms']:7.3f} ms "
          f"({r['ns_per_row']:5.3f} ns/row)", flush=True)


def cmd_planescale(args, dev):
    r = planescale(dev)
    print(f"--- plane_scale, 2 * gbuf[16] of a (24, {r['height']}, {r['width']}) f32 G-buffer, {r['n']} calls; "
          "ms by CUDA events / device ms by torch.profiler ---")
    for g in r["geometries"]:
        cells = [f"{t} threads {m['ms']:.4f} / {fmt(m['dev_ms'])}" for t, m in g["threads"].items()]
        mul = [f"{a:.4f} / {fmt(b)}" for a, b in zip(g["torch_mul_ms"], g["torch_mul_dev_ms"])]
        print(f"{g['geometry']}: " + "; ".join(cells) + f"; torch.mul before/after {', '.join(mul)}", flush=True)


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


COMMANDS = ("gather", "tablesize", "surface", "sort", "scatter", "shade", "vmemtake", "planescale")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        p = sub.add_parser(name)
        if name == "gather":
            p.add_argument("--mb", type=int, default=512)
        if name == "shade":
            p.add_argument("--data-dir", required=True, help="the reference's data directory (meshes/, textures/)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("microbench: torch.cuda.is_available() is false; the probes time an NVIDIA GPU")
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    globals()[f"cmd_{args.cmd}"](args, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
