"""tpurast_torch resolve (plain version of csrc/resolve.cu) against the
JAX reference's forward G-buffer, Renderer.debug_gbuf(with_fid=True), on
the CPU: the same scene state (the reference's device tree, converted with
np.asarray) and camera through both packages.

Budgets:
  * face id exact (it selects the attribute row);
  * integer-valued planes (atlas offset, mip dims, matched flag, texture
    id, l0, page bases) exact, outside pixels whose lod sits on a mip
    boundary and flips l0 (log2 differs by an ulp between XLA and torch),
    which must stay under 0.1% of covered pixels;
  * interpolated planes (world, normal, uv) and the major-axis uv
    derivatives (planes 14, 15) within rtol 1e-5, atol 1e-6;
  * the mip fraction (plane 13) and the probe span (plane 17) within an
    absolute 8e-6 and 3e-6. Both come from differences of products
    (gx*esum - nval*d_x) that XLA:CPU contracts into FMAs inside the
    interpret-mode kernel while the port rounds every product; where the
    difference cancels, that moves them by more than rtol 1e-5 allows.
    Largest deviations measured on these two scenes: plane 13 6.7e-6,
    plane 17 2.5e-6 (both on "orbit"); each limit sits just above.
"""

import jax
import numpy as np
import pytest
import torch

from tpurast.camera import Camera
from tpurast.config import RendererConfig
from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch.device.scene import build_orbit_scene, from_numpy, orbit_track
from tpurast_torch.kernels import resolve
from tpurast_torch.renderer import Renderer
from test_sampler import _checker_scene
from test_torch_scene import numpy_bc_decoders, reference_scene  # noqa: F401  (module-wide autouse)

INTERP_PLANES = [0, 1, 2, 3, 4, 5, 6, 7]
DERIV_PLANES = [14, 15]


def _gbufs(scene, cfg, cam):
    ref = RefRenderer(reference_scene(scene), cfg)
    g_r, f_r = ref.debug_gbuf(cam, with_fid=True)
    port = Renderer(scene, cfg, device="cpu")
    port.scene = from_numpy(jax.tree.map(np.asarray, ref.scene), "cpu")
    g_p, f_p = port.debug_gbuf(cam, with_fid=True)
    return np.asarray(g_r), np.asarray(f_r), g_p.numpy(), f_p.numpy()


SCENES = {
    # Grazing checkered floor, max_anisotropy 16 (tests/test_sampler.py).
    "checker": lambda: (
        _checker_scene(),
        RendererConfig(width=128, height=64, segment_headroom=256),
        Camera.from_target([0.0, -0.12, -6.0], [0.0, -0.02, 2.0]),
    ),
    # chip_smoke.py's scene, small: many tiny faces, several textures.
    "orbit": lambda: (
        build_orbit_scene(seed=0, floor_quads=64, spheres=3, rings=16, segments=16, tex_size=128, n_textures=4),
        RendererConfig(width=256, height=128, segment_headroom=512),
        orbit_track(8)[1],
    ),
}


@pytest.fixture(scope="module", params=list(SCENES))
def gbufs(request):
    return _gbufs(*SCENES[request.param]())


def test_face_ids_exact(gbufs):
    _, f_r, _, f_p = gbufs
    assert (f_r >= 0).sum() > 1000
    np.testing.assert_array_equal(f_p, f_r)


def _flips(gbufs):
    g_r, f_r, g_p, _ = gbufs
    flip = (g_r[19] != g_p[19]) & (f_r >= 0)
    assert flip.sum() <= 0.001 * (f_r >= 0).sum(), f"{flip.sum()} l0 flips"
    return flip


def test_integer_planes_exact(gbufs):
    g_r, _, g_p, _ = gbufs
    keep = ~_flips(gbufs)
    for i in resolve.INT_PLANES:
        np.testing.assert_array_equal(g_p[i][keep], g_r[i][keep], err_msg=f"plane {i}")


def test_unmatched_pixels_all_zero(gbufs):
    g_r, f_r, g_p, _ = gbufs
    assert (g_p[:, f_r < 0] == 0).all() and (g_r[:, f_r < 0] == 0).all()


@pytest.mark.parametrize(
    "planes,rtol,atol",
    [(INTERP_PLANES, 1e-5, 1e-6), (DERIV_PLANES, 1e-5, 1e-6), ([13], 0.0, 8e-6), ([17], 0.0, 3e-6)],
    ids=["interpolated", "derivative", "mip_fraction", "probe_span"],
)
def test_float_planes_close(gbufs, planes, rtol, atol):
    g_r, _, g_p, _ = gbufs
    keep = ~_flips(gbufs)
    for i in planes:
        np.testing.assert_allclose(g_p[i][keep], g_r[i][keep], rtol=rtol, atol=atol, err_msg=f"plane {i}")


def test_resolve_gbuffer_on_cpu_is_the_plain_version():
    """resolve_gbuffer on CPU tensors is the plain version on the joined
    table, bit for bit."""
    vis = torch.full((2, 8, 128), -1.0)
    setup, table = torch.zeros((1, 24)), torch.zeros((1, resolve.TABLE_WIDTH))
    attrs = resolve.join_attrs(setup, table)
    assert attrs.shape == (1, resolve.A_IN)
    assert torch.equal(resolve.resolve_gbuffer(vis, setup, table), resolve.resolve_gbuffer_plain(vis, attrs))
    assert not resolve.resolve_gbuffer(vis, setup, table).any()
