"""tpurast_torch gather and deferred shading against the JAX package (CPU).

The reference's forward G-buffer, face ids and triangle setup of one
frame of the small orbit scene (256x128, tests/test_torch_renderer.py's)
at max_anisotropy 1 and 4 go through tpurast.kernels.shade and
tpurast_torch.kernels.shade with the same atlas rows, float32 and srgb8:

  * pack_tex_table, pack_shade_rows and resolve.pack_resolve_attrs: bit
    for bit (the int32 texture info bit-cast into the f32 row), with and
    without texture pages; each the setup columns beside its per-scene
    table (scene_table), which the upload builds once;
  * _plane_select: exact, also at level indices outside [0, 16);
  * _trilerp at random (u, v) over the atlas: rtol 2e-6 / atol 1e-6 per
    channel (XLA:CPU contracts the bilinear a*b+c into FMAs; eager torch
    rounds each operation);
  * shade_gbuffer and shade_deferred: within 1 LSB per channel after the
    sRGB u8 encode, the same pixels covered;
  * shade_deferred with y_offset shades a band of rows exactly as the
    full frame does, and an uncovered G-buffer shades to the clear color;
  * the wrappers on CPU tensors are the plain versions (shade_deferred on
    the setup rows and per-scene table put together) and count no
    launch, hold no fallback, and check the atlas rows as csrc/shade.cu
    takes them (dtype with texel format, shape, each format's alignment,
    srgb8 rows' decode table), which the scene upload makes once.

Time on one worker: about 20 s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurast.config import RendererConfig
from tpurast.kernels import geometry as ref_geometry
from tpurast.kernels import resolve as ref_resolve
from tpurast.kernels import shade as ref_shade
from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.device.textures import upload_atlas
from tpurast_torch.kernels import present, resolve, shade
from test_torch_scene import numpy_bc_decoders, reference_scene  # noqa: F401  (module-wide autouse)

CFG = RendererConfig(width=256, height=128, segment_headroom=512, sampler="gather")
FORMATS = {"float": "float32", "srgb8": "srgb8"}


def _light(cfg):
    return dict(light_direction=cfg.light_direction, light_color=cfg.light_color,
                ambient_amount=cfg.ambient_amount, specular_power=cfg.specular_power,
                clear_color=cfg.clear_color, blend=cfg.blend)


@pytest.fixture(scope="module")
def scene():
    return build_orbit_scene(seed=0, floor_quads=64, spheres=4, rings=16, segments=16, tex_size=128, n_textures=4)


@pytest.fixture(scope="module")
def scene_ref(scene):
    """The same scene as the reference's record."""
    return reference_scene(scene)


@pytest.fixture(scope="module")
def texels(scene, scene_ref):
    """{texel_format: (reference jnp rows, port tensor rows)}."""
    return {fmt: (jnp.asarray(scene_ref.atlas.device(dt)["texels"]), upload_atlas(scene.atlas, dt, "cpu")["texels"])
            for fmt, dt in FORMATS.items()}


@pytest.fixture(scope="module", params=[1, 4], ids=["aniso1", "aniso4"])
def frame(request, scene_ref):
    """The reference's G-buffer, face ids, setup, shade rows and camera
    position for one frame at max_anisotropy 1 or 4."""
    cfg = dataclasses.replace(CFG, max_anisotropy=request.param)
    r = RefRenderer(scene_ref, cfg)
    cam = orbit_track(8)[3]
    gbuf, fid = r.debug_gbuf(cam, with_fid=True)
    vp, cp = r.frame_uniforms(cam)
    sc = r.scene
    clip = ref_geometry.transform_corners(sc["corner_world"], vp)
    setup = ref_geometry.triangle_setup(clip, None, sc["n_faces"], cfg.width, cfg.height)["setup"]
    rows = ref_shade.pack_shade_rows(setup, sc["corner_world"], sc["corner_normal"], sc["corner_uv"],
                                     sc["face_tex"], sc["atlas"])
    return dict(cfg=cfg, gbuf=gbuf, fid=fid, cp=cp, setup=setup, rows=rows, tree=jax.tree.map(np.asarray, sc))


def _t(a):
    return torch.from_numpy(np.array(a))


def _split(rows):
    """A (F, 104) packed shading table as shade_deferred takes it: the
    (F, 24) setup rows and the (F, 80) per-scene table."""
    rows = _t(np.asarray(rows))
    return rows[:, :24].contiguous(), rows[:, 24:].contiguous()


def _encode(planes, cfg):
    return present.encode_srgb_u8(torch.as_tensor(np.asarray(planes)), cfg.width, cfg.height).numpy().astype(int)


def _within_one_lsb(port, ref, cfg):
    pe, re = _encode(port, cfg), _encode(ref, cfg)
    diff = np.abs(pe - re)
    assert diff.max() <= 1, f"max {diff.max()} LSB at {(diff > 1).sum()} values"
    return diff


def test_pack_shade_rows_bit_exact(frame):
    tr = frame["tree"]
    atlas = {k: _t(tr["atlas"][k]) for k in ("offsets", "sizes", "n_mips")}
    np.testing.assert_array_equal(shade.pack_tex_table(atlas).numpy(),
                                  np.asarray(ref_shade.pack_tex_table(frame["tree"]["atlas"])))
    rows = shade.pack_shade_rows(_t(frame["setup"]), _t(tr["corner_world"]), _t(tr["corner_normal"]),
                                 _t(tr["corner_uv"]), _t(tr["face_tex"]), atlas)
    assert rows.shape == (tr["corner_world"].shape[0], shade.SHADE_ROW_WIDTH) and rows.dtype == torch.float32
    np.testing.assert_array_equal(rows.view(torch.int32).numpy(), np.asarray(frame["rows"]).view(np.int32))


@pytest.mark.parametrize("pages", [True, False], ids=["pages", "no_pages"])
def test_pack_resolve_attrs_bit_exact(frame, pages):
    """pack_resolve_attrs equals the reference's table bit for bit, with
    the scene's page origins and without them (zero page bases); it is
    the setup rows' edge matrix, anchor and face id beside scene_table's
    first 77 columns, the table's last 3 zeros."""
    tr = frame["tree"]
    keys = ("offsets", "sizes", "n_mips") + (("page_origins",) if pages else ())
    assert "page_origins" in tr["atlas"]
    ref_atlas = {k: tr["atlas"][k] for k in keys}
    atlas = {k: _t(v) for k, v in ref_atlas.items()}
    corners = [_t(tr[k]) for k in ("corner_world", "corner_normal", "corner_uv", "face_tex")]
    setup = _t(frame["setup"])
    attrs = resolve.pack_resolve_attrs(setup, *corners, atlas)
    want = np.asarray(ref_resolve.pack_resolve_attrs(frame["setup"], tr["corner_world"], tr["corner_normal"],
                                                     tr["corner_uv"], tr["face_tex"], ref_atlas))
    assert attrs.shape == (tr["corner_world"].shape[0], resolve.A_IN) and attrs.dtype == torch.float32
    np.testing.assert_array_equal(attrs.view(torch.int32).numpy(), want.view(np.int32))
    table = resolve.scene_table(*corners, atlas)
    assert table.shape == (attrs.shape[0], resolve.TABLE_WIDTH) and table.is_contiguous()
    assert torch.equal(table[:, : resolve.A_IN - resolve.SETUP_COLS], attrs[:, resolve.SETUP_COLS:])
    assert not table[:, resolve.A_IN - resolve.SETUP_COLS:].any()
    assert torch.equal(setup[:, [0, 1, 2, 3, 4, 5, 6, 7, 8, 16, 17, 15]], attrs[:, : resolve.SETUP_COLS])
    assert (attrs[:, 73:] == 0).all().item() != pages


def test_pack_shade_rows_is_setup_beside_the_scene_table(frame):
    """pack_shade_rows is the setup rows beside shade.scene_table, the
    table's int32 texture info bit for bit (join_shade_rows)."""
    tr = frame["tree"]
    atlas = {k: _t(tr["atlas"][k]) for k in ("offsets", "sizes", "n_mips")}
    corners = [_t(tr[k]) for k in ("corner_world", "corner_normal", "corner_uv", "face_tex")]
    setup = _t(frame["setup"])
    table = shade.scene_table(*corners, atlas)
    assert table.shape == (setup.shape[0], shade.TABLE_WIDTH) and table.dtype == torch.float32
    rows = shade.pack_shade_rows(setup, *corners, atlas)
    assert torch.equal(rows.view(torch.int32), shade.join_shade_rows(setup, table).view(torch.int32))
    assert torch.equal(rows[:, :24], setup)


def test_plane_select_matches_reference():
    rng = np.random.default_rng(5)
    planes = rng.integers(-(2**31), 2**31 - 1, (16, 9, 7), dtype=np.int64).astype(np.int32)
    lane = rng.integers(-3, 20, (9, 7)).astype(np.int32)
    got = shade._plane_select(_t(planes), _t(lane)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_shade._plane_select(jnp.asarray(planes), jnp.asarray(lane))))
    assert (got[(lane < 0) | (lane >= 16)] == 0).all()


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_trilerp_matches_reference(scene, texels, fmt):
    ref_tex, port_tex = texels[fmt]
    rng = np.random.default_rng(9)
    n = 4096
    tex_id = rng.integers(1, scene.atlas.offsets.shape[0], n)
    level = np.minimum(rng.integers(0, 8, n), scene.atlas.n_mips[tex_id] - 1)
    parent = np.minimum(level + 1, scene.atlas.n_mips[tex_id] - 1)
    fields = [
        scene.atlas.offsets[tex_id, level], scene.atlas.sizes[tex_id, level, 0],
        scene.atlas.sizes[tex_id, level, 1], scene.atlas.sizes[tex_id, parent, 0],
        scene.atlas.sizes[tex_id, parent, 1],
    ]
    fields = [f.astype(np.int32) for f in fields]
    tfrac, u, v = (rng.uniform(lo, hi, n).astype(np.float32) for lo, hi in ((0, 1), (-3, 3), (-3, 3)))
    want = ref_shade._trilerp(ref_tex, *map(jnp.asarray, fields), jnp.asarray(tfrac), jnp.asarray(u),
                              jnp.asarray(v), fmt)
    got = shade._trilerp(port_tex, *map(_t, fields), _t(tfrac), _t(u), _t(v), fmt)
    for c in range(4):
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]), rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_shade_gbuffer_matches_reference(frame, texels, fmt):
    ref_tex, port_tex = texels[fmt]
    cfg = frame["cfg"]
    kw = dict(_light(cfg), max_anisotropy=cfg.max_anisotropy, texel_format=fmt)
    want = ref_shade.shade_gbuffer(frame["gbuf"], ref_tex, frame["cp"], **kw)
    got = shade.shade_gbuffer(_t(frame["gbuf"]), port_tex, _t(frame["cp"]), **kw)
    assert got.shape == (4, 128, 256) and got.dtype == torch.float32
    diff = _within_one_lsb(got, want, cfg)
    covered = np.asarray(frame["gbuf"])[16] > 0
    assert 0.05 < covered.mean() < 0.95
    assert (diff[:, ~covered] == 0).all()


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_shade_deferred_matches_reference(frame, texels, fmt):
    ref_tex, port_tex = texels[fmt]
    cfg = frame["cfg"]
    kw = dict(_light(cfg), max_anisotropy=cfg.max_anisotropy, texel_format=fmt)
    want = ref_shade.shade_deferred(frame["fid"], frame["rows"], ref_tex, frame["cp"], **kw)
    got = shade.shade_deferred(_t(frame["fid"]).float(), *_split(frame["rows"]), port_tex, _t(frame["cp"]), **kw)
    assert got.shape == (4, 128, 256)
    _within_one_lsb(got, want, cfg)


def test_shade_deferred_y_offset_band_equals_full_frame(frame, texels):
    _, port_tex = texels["float"]
    cfg = frame["cfg"]
    kw = dict(_light(cfg), max_anisotropy=cfg.max_anisotropy)
    fid, rows, cp = _t(frame["fid"]).float(), _split(frame["rows"]), _t(frame["cp"])
    full = shade.shade_deferred(fid, *rows, port_tex, cp, **kw)
    band = shade.shade_deferred(fid[40:72], *rows, port_tex, cp, y_offset=40, **kw)
    assert torch.equal(band, full[:, 40:72])


def test_uncovered_gbuffer_shades_to_clear_color(texels):
    _, port_tex = texels["float"]
    out = shade.shade_gbuffer(torch.zeros((24, 8, 16)), port_tex, torch.zeros(3), max_anisotropy=4,
                              **_light(CFG))
    want = torch.tensor(CFG.clear_color, dtype=torch.float32)[:, None, None].expand(4, 8, 16)
    assert torch.equal(out, want)


def test_wrappers_take_the_plain_versions_on_the_cpu(frame, texels):
    """shade_gbuffer and shade_deferred on CPU tensors are their plain
    versions, value for value, and count no launch; tensors of a device
    that is neither the CPU nor CUDA raise instead of falling back."""
    from tpurast_torch import kernels

    _, port_tex = texels["srgb8"]
    cfg = frame["cfg"]
    kw = dict(_light(cfg), max_anisotropy=cfg.max_anisotropy, texel_format="srgb8")
    g, fid, rows, cp = _t(frame["gbuf"]), _t(frame["fid"]), _t(np.asarray(frame["rows"])), _t(frame["cp"])
    setup, table = _split(frame["rows"])
    kernels.reset_launches()
    assert torch.equal(shade.shade_gbuffer(g, port_tex, cp, **kw), shade.shade_gbuffer_plain(g, port_tex, cp, **kw))
    assert torch.equal(shade.shade_deferred(fid.float(), setup, table, port_tex, cp, y_offset=3, **kw),
                       shade.shade_deferred_plain(fid, rows, port_tex, cp, y_offset=3, **kw))
    assert kernels.LAUNCHES["gather"] == kernels.LAUNCHES["deferred"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        shade.shade_gbuffer(g.to("meta"), port_tex.to("meta"), cp.to("meta"), **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        shade.shade_deferred(fid.float().to("meta"), setup.to("meta"), table.to("meta"), port_tex.to("meta"),
                             cp.to("meta"), **kw)


def test_wrappers_have_no_fallback():
    """The kernel wrappers hold no try: a CUDA tensor launches the kernel
    or raises (chip_smoke.py holds the launch on the card)."""
    import ast
    import inspect

    for fn in (shade.shade_gbuffer, shade.shade_deferred):
        tree = ast.parse(inspect.getsource(fn))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn.__name__


def test_row_check_takes_each_texel_dtype_at_its_alignment(texels):
    """csrc/shade.cu's row check: each dtype with its texel format, (N, 52)
    rows, contiguous, starting on the grid of the format's widest loads (16
    bytes for float32, float16 and bfloat16, 8 for srgb8); srgb8 rows with
    their (256,) f32 decode table on their device, _srgb_texel of 0..255,
    float rows with none."""
    rows32 = torch.rand((9, 52))
    table = shade.srgb_table("cpu")
    for dtype, code in shade.ROW_FORMATS.items():
        fmt = "srgb8" if dtype == torch.uint8 else "float"
        t = (rows32 * 255).to(dtype) if dtype == torch.uint8 else rows32.to(dtype)
        got, lut = shade._check_rows(t, fmt, table)
        assert got == code and (lut is None if fmt == "float" else lut is table)
        with pytest.raises(TypeError):
            shade._check_rows(t, "float" if fmt == "srgb8" else "srgb8", table)
        with pytest.raises(ValueError):
            shade._check_rows(t[:, :51], fmt, table)
        off = torch.empty(9 * 52 + 1, dtype=dtype)[1:].view(9, 52)  # one element off the row grid
        with pytest.raises(ValueError, match="boundary"):
            shade._check_rows(off, fmt, table)
    u8 = (rows32 * 255).to(torch.uint8)
    with pytest.raises(ValueError, match="srgb_lut"):
        shade._check_rows(u8, "srgb8", None)
    with pytest.raises(ValueError, match="srgb_lut"):
        shade._check_rows(u8, "srgb8", table[:255])
    with pytest.raises(TypeError, match="srgb_lut"):
        shade._check_rows(u8, "srgb8", table.double())
    with pytest.raises(ValueError, match="texel format"):
        shade._check_rows(rows32, "linear", table)
    c8 = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(table, shade._srgb_texel(c8)) and table.shape == (256,)


@pytest.mark.parametrize("texture_dtype", ["srgb8", "float16"])
def test_upload_makes_the_srgb8_table_once(scene, texture_dtype):
    """The scene upload makes srgb8 rows' decode table beside them, once
    (no frame builds it): srgb_table on the rows' device; float rows get
    none. A replica carries its own copy."""
    from tpurast_torch.device import scene as scene_mod

    up = scene_mod.upload(scene, "cpu", texture_dtype=texture_dtype)
    if texture_dtype == "float16":
        assert "srgb_lut" not in up["atlas"]
        return
    lut = up["atlas"]["srgb_lut"]
    assert lut.device == up["atlas"]["texels"].device and torch.equal(lut, shade.srgb_table("cpu"))
    rep = scene_mod.replicate(up, "cpu")
    assert torch.equal(rep["atlas"]["srgb_lut"], lut)
