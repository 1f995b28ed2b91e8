"""The pose tools (tpurast_torch/tools/fit_pose.py and parity_render.py)
on the CPU, against the reference's tools/fit_pose.py and Renderer, at
tests/test_torch_runtime.py's TINY orbit scene and 130x70: two tile
columns, the second holding 2 px.

  * ref_mask equals the reference's on real screenshot content, mask and
    image exactly: the left half of docs/parity/hello_dragon_side_by_side.png
    (a screenshot without its title bar) under 31 rows; brown equals
    tests/test_parity.py's copy of the reference's classifier there;
  * the search: the reference's main() (tools/ has no package, so it is
    loaded from its file) with --scene demo answered by the TINY scene, and
    the port's main() on the same scene, screenshot, size, centre and radii,
    print the same lines and write the same JSON, IoU exactly: coverage
    masks over 12 iterations, brown masks over 3, and a warm start (--seed
    with the first run's pose, 3 iterations: a "seed IoU" line, no jumps).
    The reference's Renderer is made once per configuration, so its frame
    compiles once for the module (about 20 s of its ~30);
  * parity_render: render_poses within 1 LSB of the reference's
    render_to_host with equal coverage; side_by_side; main() writes both
    PNGs of each pose, exits 2 naming a missing screenshot, and its default
    --out lies outside docs/;
  * without a card and without --device cpu both tools exit 2 and print
    nothing; a missing --ref, --seed or data directory exits 2 naming it;
  * with the reference's data directory only (tests/test_parity.py's
    counterpart): the poses of docs/parity/poses.json rendered by the port
    keep their fitted IoU less 0.05 against the screenshots in
    docs/parity.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import tpurast.config
import tpurast.device.scene
import tpurast.renderer
from tpurast.config import RendererConfig as RefRendererConfig
from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.device import scene as scene_mod
from tpurast_torch.device.scene import build_orbit_scene, orbit_camera
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import fit_pose, parity_render
from test_parity import _brown as parity_brown
from test_torch_runtime import TINY
from test_torch_scene import numpy_bc_decoders, reference_scene  # noqa: F401  (module-wide autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H = 130, 70
HEADROOM = 512  # tests/test_torch_runtime.py's TINY_CFG: the reference drops no segment
TRUE_CAM = orbit_camera(0.7)  # aimed at (0, 1, 0), the search's centre
SEARCH = ["--width", str(W), "--height", str(H), "--center", "0", "1", "0", "--rmin", "10.5", "--rmax", "13",
          "--sigma", "0.5", "--scene", "demo"]
RUNS = {"coverage": ["--mask-mode", "coverage", "--iters", "12"],
        "brown": ["--mask-mode", "brown", "--iters", "3"],
        "warm": ["--mask-mode", "coverage", "--iters", "3", "--seed"]}


def _left_half(name: str) -> np.ndarray:
    """The screenshot of docs/parity/{name}_side_by_side.png (its left
    half: the screenshot, an 8-px band, the reference's frame)."""
    img = np.asarray(Image.open(REPO / "docs" / "parity" / f"{name}_side_by_side.png").convert("RGB"))
    return img[:, : (img.shape[1] - parity_render.BAND_PX) // 2]


def _with_title(img: np.ndarray) -> np.ndarray:
    return np.concatenate([np.full((fit_pose.TITLE_PX, img.shape[1], 3), 200, np.uint8), img])


@pytest.fixture(scope="module")
def ref_tool():
    spec = importlib.util.spec_from_file_location("reference_fit_pose", REPO / "tools" / "fit_pose.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scenes():
    port = build_orbit_scene(seed=1, **TINY)
    return port, reference_scene(port)


@pytest.fixture(scope="module")
def ref_renderer():
    """The reference's Renderer, one per (scene, config) for the module."""
    made = {}

    def make(scene, config):
        key = (id(scene), config)
        if key not in made:
            made[key] = RefRenderer(scene, config)
        return made[key]

    return make


@pytest.fixture(scope="module")
def shot(tmp_path_factory, scenes):
    """A screenshot of the TINY scene from TRUE_CAM: the port's frame under
    31 title rows, as a PNG."""
    frame = Renderer(scenes[0], RendererConfig(width=W, height=H), device="cpu").render_to_host(TRUE_CAM)
    path = tmp_path_factory.mktemp("shot") / "shot.png"
    Image.fromarray(_with_title(np.ascontiguousarray(frame[..., :3]))).save(path)
    return path


@pytest.fixture(scope="module")
def ref_runs(ref_tool, scenes, ref_renderer, shot, tmp_path_factory):
    """{run: (stdout lines, the JSON file's text)} of the reference's
    main() for each of RUNS (the warm start from the coverage run's pose)."""
    d = tmp_path_factory.mktemp("ref")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpurast.device.scene, "load_demo_scene", lambda data_dir: scenes[1])
        mp.setattr(tpurast.config, "RendererConfig",
                   lambda **kw: RefRendererConfig(segment_headroom=HEADROOM, **kw))
        mp.setattr(tpurast.renderer, "Renderer", ref_renderer)
        mp.setattr(sys, "path", list(sys.path))  # the tool puts its repository first
        for run, opts in RUNS.items():
            argv = SEARCH + ["--ref", str(shot), "--data-dir", str(d), "--out", str(d / f"{run}.json")] + opts
            if run == "warm":
                argv.append(str(d / "coverage.json"))
            mp.setattr(sys, "argv", ["fit_pose.py"] + argv)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert ref_tool.main() == 0
            out[run] = (buf.getvalue().splitlines(), (d / f"{run}.json").read_text())
    return out


def test_ref_mask_matches_reference_on_a_screenshot(ref_tool, tmp_path):
    full = _with_title(_left_half("hello_dragon"))
    path = tmp_path / "hello_dragon.png"
    Image.fromarray(full).save(path)
    want_mask, want_img = ref_tool.ref_mask(str(path), 320, 180)
    for got_mask, got_img in (fit_pose.ref_mask(str(path), 320, 180), fit_pose.ref_mask(full, 320, 180)):
        np.testing.assert_array_equal(got_mask, want_mask)
        np.testing.assert_array_equal(got_img, want_img)
    assert 0.02 < want_mask.mean() < 0.9


def test_brown_matches_reference_copy():
    img = _left_half("specular_map")
    np.testing.assert_array_equal(fit_pose.brown(img), parity_brown(img))
    assert fit_pose.brown(img).any()


@pytest.mark.parametrize("run", list(RUNS))
def test_search_matches_reference(run, ref_runs, scenes, shot, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(scene_mod, "load_demo_scene", lambda data_dir: scenes[0])
    out = tmp_path / f"{run}.json"
    argv = SEARCH + ["--ref", str(shot), "--data-dir", str(tmp_path), "--out", str(out), "--device", "cpu"]
    argv += RUNS[run]
    if run == "warm":
        warm = tmp_path / "warm_start.json"
        warm.write_text(ref_runs["coverage"][1])
        argv.append(str(warm))
    assert fit_pose.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    want_lines, want_json = ref_runs[run]
    assert lines[:-1] == want_lines[:-1]
    assert lines[-1] == want_lines[-1].rsplit(" -> ", 1)[0] + f" -> {out}"
    assert out.read_text() == want_json
    res = json.loads(want_json)
    assert list(res) == ["iou", "position", "target", "scene", "ref"] and res["iou"] > 0
    if run == "warm":
        assert lines[0].startswith("seed IoU ") and float(lines[0].split()[-1]) == pytest.approx(
            json.loads(ref_runs["coverage"][1])["iou"], abs=5e-5)
    else:
        assert lines[0].startswith("iter 0: IoU ") and len(lines) >= 3


def test_search_takes_no_jump_draw_after_a_warm_start():
    """search() draws only the refinement steps after a warm start: 6
    normals an iteration, no uniform."""
    seen = []

    def render_mask(cam):
        seen.append(cam.position.copy())
        return np.ones((2, 2), bool)

    warm = {"position": [0.0, -1.0, -5.0], "target": [0.0, 0.0, 0.0]}
    score, pos, tgt = fit_pose.search(render_mask, np.ones((2, 2), bool), (0, 0, 0), iters=2, rmin=1, rmax=2,
                                      sigma=0.1, warm=warm, log=lambda line: None)
    rng = np.random.default_rng(0)
    step = rng.normal(0, 0.1, 3)
    assert len(seen) == 3 and score == 1.0
    np.testing.assert_array_equal(seen[1], (np.array(warm["position"]) + step).astype(np.float32))
    np.testing.assert_array_equal(pos, warm["position"])


def test_render_poses_off_grid_matches_reference(scenes, ref_renderer):
    cams = [orbit_camera(0.7), orbit_camera(2.1), orbit_camera(4.0, radius=8.0)]
    specs = [{"position": c.position.tolist(), "target": [0.0, 1.0, 0.0]} for c in cams]
    got = parity_render.render_poses(scenes[0], specs, width=W, height=H, device="cpu")
    ref = ref_renderer(scenes[1], RefRendererConfig(width=W, height=H, segment_headroom=HEADROOM))
    port = Renderer(scenes[0], RendererConfig(width=W, height=H), device="cpu")
    edge = 0
    for spec, ours in zip(specs, got):
        cam = Camera.from_target(np.asarray(spec["position"], np.float32), np.asarray(spec["target"], np.float32))
        want = ref.render_to_host(cam)[..., :3]
        assert ours.shape == (H, W, 3) and ours.dtype == np.uint8
        assert np.abs(ours.astype(np.int32) - want).max() <= 1
        cover = np.asarray(ref.render(cam)["depth"]) > 0
        np.testing.assert_array_equal(port.render(cam)["depth"].numpy() > 0, cover)
        edge += int(cover[:, 128:].sum())
    assert edge > 0  # the second tile column's 2 px hold geometry


def test_side_by_side():
    ref_img = np.zeros((5, 7, 3), np.uint8)
    ours = np.full((5, 6, 3), 9, np.uint8)
    side = parity_render.side_by_side(ref_img, ours)
    assert side.shape == (5, 7 + parity_render.BAND_PX + 6, 3) and side.dtype == np.uint8
    assert (side[:, 7:7 + parity_render.BAND_PX] == 255).all()
    np.testing.assert_array_equal(side[:, :7], ref_img)
    np.testing.assert_array_equal(side[:, 7 + parity_render.BAND_PX:], ours)


def test_parity_render_main(scenes, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(scene_mod, "load_demo_scene", lambda data_dir: scenes[0])
    poses, shots = {}, {}
    for name, angle in (("first", 0.7), ("second", 2.1)):
        cam = orbit_camera(angle)
        shots[name] = np.full((fit_pose.TITLE_PX + H, W, 3), 40 * len(name), np.uint8)
        Image.fromarray(shots[name]).save(tmp_path / f"{name}.png")
        poses[name] = {"ref": str(tmp_path / f"{name}.png"), "scene": "demo", "mask": "coverage", "iou": 0.5,
                       "position": cam.position.tolist(), "target": [0.0, 1.0, 0.0]}
    poses_json = tmp_path / "poses.json"
    poses_json.write_text(json.dumps(poses))
    monkeypatch.setattr(parity_render, "POSES_JSON", poses_json)
    out = tmp_path / "out"
    argv = ["--data-dir", str(tmp_path), "--out", str(out), "--device", "cpu"]
    assert parity_render.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{n}: {W}x{H} IoU(fit)=0.500 -> {n}_side_by_side.png" for n in poses]
    frames = parity_render.render_poses(scenes[0], poses.values(), width=W, height=H, device="cpu")
    for (name, spec), frame in zip(poses.items(), frames):
        ours = np.asarray(Image.open(out / f"{name}_tpurast_torch.png"))
        np.testing.assert_array_equal(ours, frame)
        side = np.asarray(Image.open(out / f"{name}_side_by_side.png"))
        np.testing.assert_array_equal(side, parity_render.side_by_side(shots[name][fit_pose.TITLE_PX:], frame))

    poses["second"]["ref"] = str(tmp_path / "missing.png")
    poses_json.write_text(json.dumps(poses))
    assert parity_render.main(argv + ["--out", str(tmp_path / "out2")]) == 2
    res = capsys.readouterr()
    assert res.out == "" and str(tmp_path / "missing.png") in res.err and not (tmp_path / "out2").exists()


def test_parity_render_writes_outside_docs():
    out = parity_render.DEFAULT_OUT.relative_to(REPO)
    assert out == pathlib.Path("tpurast_torch/_build/parity") and "docs" not in out.parts


@pytest.mark.parametrize("mod,argv", [(fit_pose, ["--ref", "shot.png"]), (parity_render, [])],
                         ids=["fit_pose", "parity_render"])
def test_pose_tool_without_a_card_exits_2(monkeypatch, capsys, mod, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err


@pytest.mark.parametrize("case", ["ref", "seed", "data_dir"])
def test_fit_pose_names_a_missing_file(case, shot, capsys, tmp_path):
    missing = str(tmp_path / "missing")
    argv = {"ref": ["--ref", missing],
            "seed": ["--ref", str(shot), "--seed", missing],
            "data_dir": ["--ref", str(shot), "--scene", "dragon", "--data-dir", missing]}[case]
    assert fit_pose.main(argv + ["--device", "cpu", "--out", str(tmp_path / "pose.json")]) == 2
    res = capsys.readouterr()
    assert res.out == "" and missing in res.err and not (tmp_path / "pose.json").exists()


@pytest.mark.parametrize("name", ["hello_dragon", "specular_map", "complex_textured_models"])
def test_fitted_poses_keep_their_iou(data_dir, name):
    """tests/test_parity.py on the port: the silhouette (dragon) or crate
    mask (demo scene) at 256x144 against the screenshot's."""
    spec = json.loads(parity_render.POSES_JSON.read_text())[name]
    w, h = 256, 144
    scene = fit_pose.load_scene(spec["scene"], str(data_dir))
    frame = Renderer(scene, RendererConfig(width=w, height=h), device="cpu")
    cam = Camera.from_target(np.asarray(spec["position"], np.float32), np.asarray(spec["target"], np.float32))
    ref = fit_pose.resized(_left_half(name), w, h)
    if spec["mask"] == "brown":
        ours, mask_ref = fit_pose.brown(frame.render_to_host(cam)), fit_pose.brown(ref)
    else:
        ours = frame.render(cam)["depth"].numpy() > 0
        corners = np.concatenate([ref[2:10, -10:-2], ref[-10:-2, 2:10], ref[-10:-2, -10:-2]])
        bg = np.median(corners.reshape(-1, 3), axis=0)
        mask_ref = np.abs(ref.astype(np.float32) - bg).sum(-1) > 110
    assert fit_pose.iou(ours, mask_ref) > spec["iou"] - 0.05
