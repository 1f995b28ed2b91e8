"""The microbenchmark probes and tools of the port, on the CPU.

  * vmem_take_plain and plane_scale_plain (kernels/probes.py, the plain
    versions of csrc/probes.cu) against the Pallas kernel bodies of
    tools/microbench.py cmd_vmemtake and tools/microbench_pipeline.py,
    rebuilt here at a small size and run with interpret=True. vmem_take:
    within 4e-6 absolute (4 ulp of a 16-term sum of values in [0, 1): the
    Pallas body sums in XLA's order, the port left to right), and equal
    to numpy's left-to-right f32 sum exactly, also at an odd row count, a
    ragged index count (the shapes the card holds the kernel to), and with
    indices outside the table against numpy alone. plane_scale: exact, in the three launch
    geometries;
  * the wrappers take the plain versions for CPU tensors;
  * each tools.microbench subcommand function and tools.microbench_pipeline
    run at a tiny size with a timer that calls once, and the helpers they
    time agree with numpy (gather sums, the stable sort, the scatter);
  * timing without a CUDA device fails instead of falling back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpurast_torch.device.scene import load_demo_scene
from tpurast_torch.device.textures import upload_atlas
from tpurast_torch.kernels import probes
from tpurast_torch.tools import microbench as mb
from tpurast_torch.tools import microbench_pipeline as mp

CPU = torch.device("cpu")


def once(fn, n=0):
    """A timer that only runs fn: the CPU tests check the work, not time."""
    fn()
    return 0.0


def _pallas_vmem_take(table, idx, blk):
    """tools/microbench.py cmd_vmemtake's kernel, interpret mode."""
    rows, width = table.shape
    n = idx.shape[0]

    def kernel(tab_ref, idx_ref, out_ref):
        i = idx_ref[:]
        out_ref[:] = jnp.take(tab_ref[:], i[0], axis=0).sum(axis=-1)[None, :]

    return pl.pallas_call(
        kernel,
        grid=(n // blk,),
        in_specs=[
            pl.BlockSpec((rows, width), lambda g: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, blk), lambda g: (0, g), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, blk), lambda g: (0, g), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, n), jnp.float32),
        interpret=True,
    )(table, idx.reshape(1, -1))[0]


def _scale_plane16(g_ref, o_ref):
    o_ref[...] = g_ref[16:17] * 2.0


def _scale_block(g_ref, o_ref):
    o_ref[...] = g_ref[...] * 2.0


def _pallas_plane_copy(g, geometry, th, tw, tiles_x, tiles_y):
    """tools/microbench_pipeline.py's three kernels, interpret mode."""
    a, h, w = g.shape

    def tile(i):
        return (0, i // tiles_x, i % tiles_x)

    grid, kernel, in_block, out_block, index_map = {
        "tile_grid": ((tiles_x * tiles_y,), _scale_plane16, (a, th, tw), (1, th, tw), tile),
        "one_plane": ((tiles_x * tiles_y,), _scale_block, (1, th, tw), (1, th, tw), tile),
        "row_band": ((tiles_y,), _scale_plane16, (a, th, w), (1, th, w), lambda i: (0, i, 0)),
    }[geometry]
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[pl.BlockSpec(in_block, index_map, memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(out_block, index_map, memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, h, w), jnp.float32),
        interpret=True,
    )(g[16:17] if geometry == "one_plane" else g)


def test_vmem_take_plain_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    table = rng.uniform(0, 1, (64, 16)).astype(np.float32)
    idx = rng.integers(0, 64, 512).astype(np.int32)
    want = np.asarray(_pallas_vmem_take(jnp.asarray(table), jnp.asarray(idx), 128))
    got = probes.vmem_take_plain(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    assert got.shape == (512,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    left_to_right = table[idx, 0]
    for j in range(1, 16):
        left_to_right = left_to_right + table[idx, j]
    np.testing.assert_array_equal(got, left_to_right)


@pytest.mark.parametrize(
    "rows,n,keep,blk",
    [(63, 512, 512, 128), (64, 512, 475, 128), (4095, 256, 219, 256)],
    ids=["odd_rows", "ragged_n", "tool_rows_less_one_ragged"],
)
def test_vmem_take_plain_at_the_shapes_the_card_checks(rows, n, keep, blk):
    """The shapes chip_smoke.py adds for the kernel: an odd row count and a
    count of indices that is no multiple of the kernel's warp or block (the
    Pallas grid takes whole blocks, so the ragged count is cut from a padded
    run). Indices outside the table are the port's own rule, clamped into
    it: the tool passes none, and the Pallas body's jnp.take would fill
    their sums with NaN, so they are held to numpy alone."""
    rng = np.random.default_rng(rows)
    table = rng.uniform(0, 1, (rows, 16)).astype(np.float32)
    idx = rng.integers(0, rows, n).astype(np.int32)
    want = np.asarray(_pallas_vmem_take(jnp.asarray(table), jnp.asarray(idx), blk))[:keep]
    got = probes.vmem_take(torch.from_numpy(table), torch.from_numpy(idx[:keep])).numpy()
    assert got.shape == (keep,)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    wild = rng.integers(0, rows, keep).astype(np.int32)
    wild[::7] = np.resize(np.array([-4, -1, rows, rows + 3], np.int32), wild[::7].shape)
    clamped = np.clip(wild, 0, rows - 1)
    left_to_right = table[clamped, 0]
    for j in range(1, 16):
        left_to_right = left_to_right + table[clamped, j]
    np.testing.assert_array_equal(probes.vmem_take(torch.from_numpy(table), torch.from_numpy(wild)).numpy(),
                                  left_to_right)


def test_vmem_take_wrapper_on_cpu_and_index_clamp():
    table = torch.arange(32 * 16, dtype=torch.float32).reshape(32, 16)
    idx = torch.tensor([0, 31, -5, 40, 7], dtype=torch.int32)
    out = probes.vmem_take(table, idx)
    assert torch.equal(out, probes.vmem_take_plain(table, idx))
    clamped = torch.tensor([0, 31, 0, 31, 7])
    assert torch.equal(out, table[clamped].sum(dim=1))


@pytest.mark.parametrize("geometry", ["tile_grid", "one_plane", "row_band"])
def test_plane_scale_plain_matches_pallas_kernels(geometry):
    th, tw, tiles_x, tiles_y = 8, 32, 3, 2
    g = np.random.default_rng(1).uniform(-1, 1, (24, tiles_y * th, tiles_x * tw)).astype(np.float32)
    want = np.asarray(_pallas_plane_copy(jnp.asarray(g), geometry, th, tw, tiles_x, tiles_y))
    src, plane = (torch.from_numpy(g[16:17].copy()), 0) if geometry == "one_plane" else (torch.from_numpy(g), 16)
    bw = tiles_x * tw if geometry == "row_band" else tw
    got = probes.plane_scale(src, plane, block_h=th, block_w=bw)
    assert got.shape == (1, tiles_y * th, tiles_x * tw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, probes.plane_scale_plain(src, plane, block_h=th, block_w=bw))


def test_microbench_helpers_match_numpy():
    rng = np.random.default_rng(2)
    table = rng.uniform(-1, 1, (50, 8)).astype(np.float16)
    idx = rng.integers(0, 50, 300).astype(np.int32)
    got = mb.gather_sum(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, table[idx].astype(np.float32).sum(-1), rtol=1e-6, atol=1e-6)
    keys = rng.integers(0, 16, 1000).astype(np.int32)
    vals = np.arange(1000, dtype=np.int32)
    sk, sv = mb.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals))
    order = np.lexsort((vals, keys))
    np.testing.assert_array_equal(sk.numpy(), keys[order])
    np.testing.assert_array_equal(sv.numpy(), vals[order])
    dest = rng.permutation(64)[:40].astype(np.int32)
    src = np.arange(40, dtype=np.int32)
    buf = np.zeros(65, np.int32)
    buf[dest] = src
    np.testing.assert_array_equal(mb.scatter_set(torch.from_numpy(dest), torch.from_numpy(src), 64).numpy(), buf)


def test_microbench_gather():
    res = mb.gather(CPU, mb=0.05, n_px=1000, timer=once)
    assert [(c["dtype"], c["width"]) for c in res["cases"]] == [
        ("float16", 52), ("float16", 16), ("float16", 8), ("float16", 4), ("float32", 16), ("float32", 4)
    ]
    assert set(res["locality_ms"]) == {"sorted", "local", "random"}


def test_microbench_tablesize():
    res = mb.tablesize(CPU, sizes_mb=(0.01, 0.02), big_mb=0.05, n_px=500, timer=once)
    assert [r["rows"] for r in res["sizes"]] == [327, 655]


def test_microbench_surface():
    res = mb.surface(CPU, rows_list=(64, 128), widths=(16, 52), max_mb=0.01, n_px=300, timer=once)
    assert res["ns_per_row"][1][1] is None and res["ns_per_row"][0][0] == 0.0


def test_microbench_sort_and_scatter():
    assert [r["p"] for r in mb.sort(CPU, sizes=(256, 1024), timer=once)["sizes"]] == [256, 1024]
    assert mb.scatter(CPU, faces=1024, timer=once)["cap"] == 2048


def test_microbench_shade_on_the_demo_scene_without_data(tmp_path):
    scene = load_demo_scene(str(tmp_path))  # no meshes: the fallback texture only
    assert scene.n_faces == 0 and scene.texture_uris == ["builtin://fallback-texture"]
    texels = upload_atlas(scene.atlas, "float16", CPU)["texels"]
    res = mb.shade(texels, CPU, height=16, width=32, timer=once)
    assert res["atlas_shape"] == tuple(texels.shape) and res["atlas_dtype"] == "float16"
    gb, _ = mb.shade_inputs(CPU, height=16, width=32)
    assert torch.isfinite(mb.trilerp_only(gb, texels)).all()
    assert torch.isfinite(mb.gather_only(gb, texels)).all()


def test_microbench_vmemtake_and_pipeline():
    assert mb.vmemtake(CPU, rows=64, n_px=512, timer=once)["n_px"] == 512
    res = mp.run(CPU, tiles_x=2, tiles_y=2, timer=once)
    assert list(res) == ["tile-grid copy", "one-plane copy", "row-band copy"]


def test_microbench_planescale():
    res = mb.planescale(CPU, tiles_x=2, tiles_y=1, n=1, timer=once, dev_timer=once)
    assert (res["height"], res["width"]) == (32, 256)
    assert [g["geometry"] for g in res["geometries"]] == ["tile-grid", "one-plane", "row-band"]
    assert all(list(g["threads"]) == list(mb.SCALE_THREADS) for g in res["geometries"])


def test_timing_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mb.cuda_ms(lambda: None)
    with pytest.raises(SystemExit):
        mb.main(["sort"])
    with pytest.raises(SystemExit):
        mp.main()
