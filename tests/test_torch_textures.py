"""tpurast_torch atlas upload and texel dtype rule against the JAX package.

  * upload_atlas(atlas, dtype) equals np.asarray of the reference's
    TextureAtlas.device(dtype)["texels"] bit for bit for float32, float16,
    bfloat16 and srgb8, with the same offsets, sizes and mip counts
    (tolerance: none), also converted in chunks of 7 rows;
  * the srgb8 encode refuses HDR content, as the reference's assert does;
  * resolve_texture_dtype follows Renderer._resolve_texture_dtype (float16,
    or srgb8 above a 2 GiB f16 atlas with LDR content), on stub atlases
    that report their size without allocating it;
  * upload(scene, device, texture_dtype) and from_numpy of the reference's
    device() tree carry the same texels.
"""

import types

import jax
import numpy as np
import pytest
import torch

from tpurast.device import scene as ref_scene
from tpurast.device.textures import build_atlas, fallback_texture, mip_chain
from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch.device import scene as port_scene
from tpurast_torch.device import textures
from test_torch_scene import _checker_models, numpy_bc_decoders  # noqa: F401  (module-wide autouse)

DTYPES = ["float32", "float16", "bfloat16", "srgb8"]


@pytest.fixture(scope="module")
def atlas():
    """Two textures: a random LDR 16x16 chain with values on and between
    the u8 boundaries, and the reference's fallback checker."""
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 1, (16, 16, 4)).astype(np.float32)
    base[0, :4, :] = [0.0, 1.0, 0.04045, 0.0031308]
    return build_atlas([mip_chain(base), fallback_texture()])


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_upload_atlas_matches_reference(atlas, dtype):
    ref = jax.tree.map(np.asarray, atlas.device(dtype))
    up = textures.upload_atlas(atlas, dtype, "cpu")
    t = up["texels"]
    assert t.shape == ref["texels"].shape and t.is_contiguous()
    if dtype == "bfloat16":
        got = t.view(torch.int16).numpy().view(np.uint16)
    else:
        got = _bits(t.numpy())
    assert got.dtype == _bits(ref["texels"]).dtype
    np.testing.assert_array_equal(got, _bits(ref["texels"]))
    for k in ("offsets", "sizes", "n_mips"):
        np.testing.assert_array_equal(up[k].numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_upload_atlas_in_chunks_matches_reference(atlas, dtype, monkeypatch):
    """texels_tensor converts ROW_CHUNK rows at a time (on the card, on the
    device): chunks of 7 rows, none aligned with a mip, give the same bits."""
    monkeypatch.setattr(textures, "ROW_CHUNK", 7)
    ref = jax.tree.map(np.asarray, atlas.device(dtype))["texels"]
    t = textures.upload_atlas(atlas, dtype, "cpu")["texels"]
    got = t.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" else _bits(t.numpy())
    np.testing.assert_array_equal(got, _bits(ref))


def test_srgb8_refuses_hdr(atlas):
    hdr = types.SimpleNamespace(texels=atlas.texels * 2.0)
    with pytest.raises(ValueError, match="LDR"):
        textures.upload_atlas(hdr, "srgb8", "cpu")
    with pytest.raises(ValueError, match="texture dtype"):
        textures.upload_atlas(atlas, "float8", "cpu")


def _stub_scene(f32_bytes: int, max_value: float):
    texels = types.SimpleNamespace(nbytes=f32_bytes)
    return types.SimpleNamespace(atlas=types.SimpleNamespace(texels=texels, max_value=lambda: max_value))


@pytest.mark.parametrize(
    "requested,f32_bytes,max_value,want",
    [
        ("auto", 1 << 20, 1.0, "float16"),
        ("auto", (4 << 30) + 4, 1.0, "srgb8"),
        ("auto", 4 << 30, 1.0, "float16"),  # exactly 2 GiB of f16 stays f16
        ("auto", 8 << 30, 3.5, "float16"),  # HDR content keeps float16
        ("float32", 8 << 30, 1.0, "float32"),
        ("bfloat16", 1 << 10, 1.0, "bfloat16"),
    ],
)
def test_resolve_texture_dtype_follows_reference(requested, f32_bytes, max_value, want):
    scene = _stub_scene(f32_bytes, max_value)
    assert textures.resolve_texture_dtype(scene, requested) == want
    assert RefRenderer._resolve_texture_dtype(scene, requested) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_scene_upload_and_from_numpy_carry_texels(dtype):
    models, assets = _checker_models()
    scene = port_scene.build_scene(models, memory_assets=assets)
    up = port_scene.upload(scene, "cpu", dtype)
    ref = ref_scene.build_scene(models, memory_assets=assets)
    tree = jax.tree.map(np.asarray, ref.device(dtype))
    again = port_scene.from_numpy(tree, "cpu")
    for t in (up["atlas"]["texels"], again["atlas"]["texels"]):
        assert t.dtype == {"srgb8": torch.uint8, "float16": torch.float16, "bfloat16": torch.bfloat16,
                           "float32": torch.float32}[dtype]
        assert torch.equal(t.view(torch.uint8), up["atlas"]["texels"].view(torch.uint8))
    np.testing.assert_array_equal(
        again["atlas"]["texels"].view(torch.uint8).numpy(), tree["atlas"]["texels"].view(np.uint8)
    )
    assert "texels" not in port_scene.upload(scene, "cpu")["atlas"]
