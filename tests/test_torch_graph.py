"""The compiled frame (tpurast_torch/graphs.py) on the CPU, where there is
no CUDA graph to capture: what a capture needs of the frame, checked
without a card.

  * test_frame_reads_nothing_back: render_frame (window, gather, deferred,
    scan) and render_frame_sharded at 2 slabs on tests/test_torch_runtime.py's
    TINY orbit scene, with the four kernel wrappers (raster, resolve, plan,
    sample) swapped for their plain versions, which run outside the guard.
    Inside it, what would read the device back or copy host data to it
    during a capture raises: Tensor.item / tolist / cpu / numpy, int(),
    float(), bool() and index() of a tensor, torch.nonzero, torch.tensor
    and torch.as_tensor of Python data, and indexing with a Python list or
    a bool tensor. The guarded frame equals the unguarded one bit for bit.
    The gather and deferred wrappers (csrc/shade.cu) take their plain
    versions here, which run inside the guard.
  * test_shade_wrappers_read_nothing_back_before_the_launch: what those two
    wrappers do on a CUDA device before the launch (the row check, the
    srgb8 decode table) reads nothing back inside the guard; so for the
    binning wrapper (csrc/bin.cu), bin_pairs' and bin_triangles', for the
    setup wrapper (csrc/setup.cu, geometry.setup_faces) and for the encode
    wrapper (csrc/encode.cu, present.encode_srgb_u8), up to its launch,
    which is recorded and not made.
  * test_forked_slabs_read_nothing_back: render_slabs' fork and join
    (parallel._fork_join, taken as on a CUDA device, with fake streams):
    each slab on a stream of its own that waits for the current stream,
    the current stream waiting for every slab, each output marked as used
    by the current stream; the forked frame reads nothing back inside the
    guard and equals the eager one.
  * FrameGraph raises on a CPU scene and Graph on CPU inputs, and neither
    calls its function.
  * sample_stage_probe and profile_sampler time graphs where graph_wanted
    holds (faked), profile_sampler's fed their own input buffers, and stay
    eager where it does not.
  * graph_wanted, Renderer.uses_graphs: eager on the CPU and inside
    kernels.plain_kernels(); a Renderer keeps one graph per output and
    recreate_swapchain drops them; make_sharded_renderer wraps its slab
    frame in a graph where graphs are wanted.

The graphs themselves (capture, replay, fresh outputs, launch counts, equal
to eager frames bit for bit) are checked on the card by chip_smoke.py's
graph_frames phase.

Time on one worker: about 7 s.
"""

import contextlib
import dataclasses
import functools

import pytest
import torch

from tpurast_torch import graphs, kernels
from tpurast_torch import parallel as parallel_mod
from tpurast_torch import renderer as renderer_mod
from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.kernels import raster, resolve, sampler
from tpurast_torch.parallel import make_sharded_renderer
from tpurast_torch.renderer import Renderer, render_frame
from tpurast_torch.tools import profile_sampler, sample_stage_probe
from test_torch_runtime import TINY
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)

CFG = RendererConfig(width=128, height=72, tile_h=8)
PATHS = {"window": {}, "gather": dict(sampler="gather"), "deferred": dict(shading="deferred"),
         "scan": dict(binning="scan"), "slabs2": {}}
# Read-backs and host-to-device copies: Tensor methods, then torch functions.
BLOCKED_METHODS = ("item", "tolist", "cpu", "numpy", "nonzero", "__int__", "__float__", "__bool__", "__index__")


class ReadBack(AssertionError):
    pass


class Guard:
    """Armed, the patched calls raise ReadBack; disarmed() lifts it for
    the plain kernel versions."""

    def __init__(self):
        self.armed = False

    @contextlib.contextmanager
    def disarmed(self):
        armed, self.armed = self.armed, False
        try:
            yield
        finally:
            self.armed = armed

    @contextlib.contextmanager
    def on(self):
        self.armed = True
        try:
            yield
        finally:
            self.armed = False


def _host_index(idx) -> bool:
    """An index that torch turns into a device tensor from host data (a
    list) or reads back (a bool tensor: its nonzero count sizes the
    result)."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(p, list) or (isinstance(p, torch.Tensor) and p.dtype == torch.bool) for p in parts)


def _install(monkeypatch, guard: Guard) -> None:
    def blocked(what, original):
        def call(*args, **kwargs):
            if guard.armed:
                raise ReadBack(what)
            return original(*args, **kwargs)
        return call

    def from_host(what, original):
        def call(data, *args, **kwargs):
            if guard.armed and not isinstance(data, torch.Tensor):
                raise ReadBack(f"{what} of host data {data!r}")
            return original(data, *args, **kwargs)
        return call

    def indexed(what, original):
        def call(self, idx, *args):
            if guard.armed and _host_index(idx):
                raise ReadBack(f"{what} with a list or bool-tensor index")
            return original(self, idx, *args)
        return call

    for name in BLOCKED_METHODS:
        monkeypatch.setattr(torch.Tensor, name, blocked(f"Tensor.{name}", getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", blocked("torch.nonzero", torch.nonzero))
    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, from_host(f"torch.{name}", getattr(torch, name)))
    for name in ("__getitem__", "__setitem__"):
        monkeypatch.setattr(torch.Tensor, name, indexed(f"Tensor.{name}", getattr(torch.Tensor, name)))
    # The kernels: their plain versions, outside the guard (on the card the
    # CUDA kernels run there, and they read nothing back; the resolve
    # kernel's plain version takes the packed table the kernel reads in its
    # two parts); the trace's stamps are the CUDA kernels' alone.
    def resolve_plain(vis, setup, table, **kwargs):
        return resolve.resolve_gbuffer_plain(vis, resolve.join_attrs(setup, table), **kwargs)

    for mod, name, plain in ((raster, "rasterize_tiles", raster.rasterize_tiles_plain),
                             (resolve, "resolve_gbuffer", resolve_plain),
                             (sampler, "plan_tiles", sampler.plan_tiles_plain),
                             (sampler, "sample_tiles", sampler.sample_tiles_plain)):
        def swapped(*args, _plain=plain, **kwargs):
            kwargs.pop("stamps", None)
            with guard.disarmed():
                return _plain(*args, **kwargs)
        monkeypatch.setattr(mod, name, swapped)


@pytest.fixture(scope="module")
def scene():
    return build_orbit_scene(seed=1, **TINY)


@pytest.fixture(scope="module")
def cam():
    return orbit_track(8)[3]


def _frame_fn(r: Renderer, path: str):
    if path == "slabs2":
        return make_sharded_renderer(r.scene, r.config, 2, r.width, r.height)
    return functools.partial(render_frame, **r._frame_kwargs)


@pytest.mark.parametrize("path", list(PATHS))
def test_frame_reads_nothing_back(scene, cam, path, monkeypatch):
    r = Renderer(scene, dataclasses.replace(CFG, **PATHS[path]), device="cpu")
    uniforms = r.frame_uniforms(cam)
    fn = _frame_fn(r, path)
    want = fn(r.scene, *uniforms)
    guard = Guard()
    _install(monkeypatch, guard)
    with guard.on():
        got = fn(r.scene, *uniforms)
    monkeypatch.undo()
    assert set(got) == {"color", "depth", "bin_overflow", "window_miss_px"} == set(want)
    assert float((want["depth"] > 0).float().mean()) > 0.1
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", ["float16", "srgb8"])
def test_shade_wrappers_read_nothing_back_before_the_launch(scene, dtype, monkeypatch):
    """shade._check_rows (with the srgb8 decode table, made before, as the
    scene upload makes it) inside the guard, on the CPU."""
    from tpurast_torch.device.textures import texels_tensor
    from tpurast_torch.kernels import shade

    rows = texels_tensor(scene.atlas.texels[:64], dtype, "cpu")
    fmt = "srgb8" if dtype == "srgb8" else "float"
    table = shade.srgb_table("cpu")
    want = shade._check_rows(rows, fmt, table)
    guard = Guard()
    _install(monkeypatch, guard)
    with guard.on():
        code, lut = shade._check_rows(rows, fmt, table)
    monkeypatch.undo()
    assert code == want[0] and (lut is None) == (want[1] is None)
    assert lut is None or lut is table


@pytest.mark.parametrize("binner", ["pairs", "scan"])
def test_bin_wrapper_reads_nothing_back_before_the_launch(scene, cam, binner, monkeypatch):
    """What geometry's binning wrapper does on a CUDA device before its
    launch (the checks, tr_bin_scratch, the outputs and scratch it
    allocates, the launch's arguments) reads nothing back inside the guard;
    the launch itself is recorded, not made."""
    from tpurast_torch.kernels import _build, geometry

    r = Renderer(scene, CFG, device="cpu")
    kw = r._frame_kwargs
    vp, _ = r.frame_uniforms(cam)
    so = geometry.triangle_setup(geometry.transform_corners(r.scene["corner_world"], vp), None,
                                 r.scene["n_faces"], kw["width"], kw["height"])
    calls = []
    monkeypatch.setattr(kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "library", lambda: type("Lib", (), {"tr_bin_scratch": lambda *args: 4096})())
    monkeypatch.setattr(_build, "call", lambda name, *args: calls.append((name, args)))
    grid = (so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"])
    guard = Guard()
    _install(monkeypatch, guard)
    before = kernels.LAUNCHES["bin"]
    with guard.on():
        out = geometry.bin_pairs(*grid, ty_base=1) if binner == "pairs" else geometry.bin_triangles(*grid, 512)
    assert [name for name, _ in calls] == ["tr_bin"] and kernels.LAUNCHES["bin"] == before + 1
    assert calls[0][1][2:5] == (None, 0, 0) and calls[0][1][-3] is None  # no clip, no face counts
    assert out["offsets"].shape == (r.tiles_x * r.tiles_y + 1,) and ("pair_tiles" in out) == (binner == "pairs")
    assert out["pair_faces"].shape == ((geometry.TILES_PER_FACE * so["aabb"].shape[0] + geometry.HUGE_BUDGET
                                        * r.tiles_x * r.tiles_y,) if binner == "pairs" else (512,))


def test_setup_wrapper_reads_nothing_back_before_the_launch(scene, cam, monkeypatch):
    """What geometry.setup_faces does on a CUDA device before its launch
    (the checks, the five outputs it allocates, the launch's arguments, the
    matrix passed by pointer) reads nothing back inside the guard; the
    launch itself is recorded, not made."""
    from tpurast_torch.kernels import _build, geometry

    r = Renderer(scene, CFG, device="cpu")
    kw = r._frame_kwargs
    vp, _ = r.frame_uniforms(cam)
    calls = []
    monkeypatch.setattr(kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "call", lambda name, *args: calls.append((name, args)))
    guard = Guard()
    _install(monkeypatch, guard)
    before = kernels.LAUNCHES["setup"]
    corners = r.scene["corner_world"]
    with guard.on():
        clip, out = geometry.setup_faces(corners, vp, r.scene["n_faces"], kw["width"], kw["height"])
    assert [name for name, _ in calls] == ["tr_setup"] and kernels.LAUNCHES["setup"] == before + 1
    assert calls[0][1][:6] == (corners, vp, corners.shape[0], r.scene["n_faces"], kw["width"], kw["height"])
    f = corners.shape[0]
    assert clip.shape == (f, 3, 4) and out["setup"].shape == (f, geometry.SETUP_WIDTH)
    assert out["valid"].dtype == torch.bool and out["aabb"].shape == (f, 4) and out["det"].shape == (f,)


@pytest.mark.parametrize("crop", ["frame", "slab"])
def test_encode_wrapper_reads_nothing_back_before_the_launch(monkeypatch, crop):
    """What present.encode_srgb_u8 does on a CUDA device before its launch
    (the checks, the output it allocates, the launch's arguments) reads
    nothing back inside the guard, for a frame's crop and a slab's; the
    launch itself is recorded, not made."""
    from tpurast_torch.kernels import _build, present

    planes = torch.zeros((4, 64, 256))
    width, height = (200, 50) if crop == "frame" else (256, 20)
    calls = []
    monkeypatch.setattr(kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "call", lambda name, *args: calls.append((name, args)))
    guard = Guard()
    _install(monkeypatch, guard)
    before = kernels.LAUNCHES["encode"]
    with guard.on():
        out = present.encode_srgb_u8(planes, width, height)
    assert [name for name, _ in calls] == ["tr_encode"] and kernels.LAUNCHES["encode"] == before + 1
    assert calls[0][1][:5] == (planes, 64, 256, width, height) and calls[0][1][5] is out
    assert out.shape == (4, height, width) and out.dtype == torch.uint8 and out.is_contiguous()


def test_guard_catches_each_read_back(monkeypatch):
    """Each blocked call raises inside the guard and works outside it."""
    guard = Guard()
    _install(monkeypatch, guard)
    t = torch.arange(4)
    reads = [lambda: t[0].item(), lambda: t.tolist(), lambda: t.cpu(), lambda: t.numpy(), lambda: t.nonzero(),
             lambda: int(t[1]), lambda: float(t[1]), lambda: bool(t[1]), lambda: [0, 1, 2][t[1]],
             lambda: torch.nonzero(t), lambda: torch.tensor([1.0]), lambda: torch.as_tensor(3),
             lambda: t[[0, 1]], lambda: t[t > 1]]
    for read in reads:
        read()
        with guard.on(), pytest.raises(ReadBack):
            read()
    with guard.on():  # device-side work passes
        assert torch.as_tensor(t) is t
        t[1:3] + torch.full((), 2.0)


def test_frame_graph_raises_on_a_cpu_scene(scene, cam):
    r = Renderer(scene, CFG, device="cpu")
    calls = []

    def fn(*args):
        calls.append(args)
        return {}

    g = graphs.FrameGraph(fn)
    with pytest.raises(ValueError, match="CUDA device"):
        g(r.scene, *r.frame_uniforms(cam))
    with kernels.plain_kernels(), pytest.raises(ValueError, match="CUDA device"):
        g(r.scene, *r.frame_uniforms(cam))
    assert calls == [] and g.capture_ms is None


def test_graphs_are_wanted_on_the_card_outside_plain_kernels():
    assert graphs.graph_wanted("cuda") and graphs.graph_wanted(torch.device("cuda", 1))
    assert not graphs.graph_wanted("cpu")
    with kernels.plain_kernels():
        assert not graphs.graph_wanted("cuda")
        with kernels.plain_kernels():
            assert not graphs.graph_wanted("cuda")
        assert not graphs.graph_wanted("cuda")
    assert graphs.graph_wanted("cuda")


def test_renderer_renders_eagerly_on_the_cpu(scene, cam, monkeypatch):
    def no_graph(*args, **kwargs):
        raise AssertionError("a CPU Renderer made a FrameGraph")

    monkeypatch.setattr(renderer_mod, "FrameGraph", no_graph)
    r = Renderer(scene, CFG, device="cpu")
    assert not r.uses_graphs
    out = r.render(cam)
    want = render_frame(r.scene, *r.frame_uniforms(cam), **r._frame_kwargs)
    assert all(torch.equal(out[k], want[k]) for k in want)
    assert r.debug_gbuf(cam).shape[0] == resolve.A_OUT
    assert r.graph_info() == {}


def test_renderer_keeps_a_graph_per_output_and_drops_them_on_resize(scene, monkeypatch):
    """Where graphs are wanted (faked here: the graph is never called), the
    Renderer makes one FrameGraph per output at the current target, with
    the target's arguments; recreate_swapchain drops them; inside
    plain_kernels() it takes render_frame."""
    r = Renderer(scene, CFG, device="cpu")
    monkeypatch.setattr(renderer_mod, "graph_wanted", lambda device: not kernels.plain_kernels_active())
    assert r.uses_graphs
    frame = r._frame_fn("frame")
    assert isinstance(frame, graphs.FrameGraph) and r._frame_fn("frame") is frame
    assert frame.fn.func is render_frame and frame.fn.keywords == dict(r._frame_kwargs, marks=r.marks)
    gbuf = r._frame_fn("gbuf", output="gbuf", shading="forward")
    assert gbuf is not frame and gbuf.fn.keywords["output"] == "gbuf"
    assert set(r.graph_info()) == {"frame", "gbuf"}
    with kernels.plain_kernels():
        assert not r.uses_graphs
        eager = r._frame_fn("frame")
        assert not isinstance(eager, graphs.FrameGraph) and eager.keywords == dict(r._frame_kwargs, marks=r.marks)
    r.recreate_swapchain(0, 0)  # ignored: the graphs stay
    assert r._frame_fn("frame") is frame
    r.recreate_swapchain(64, 32)
    assert r.graph_info() == {}
    resized = r._frame_fn("frame")
    assert resized is not frame and resized.fn.keywords["width"] == 64 and frame._graph is None


def test_sharded_renderer_is_a_graph_where_graphs_are_wanted(scene, monkeypatch):
    r = Renderer(scene, CFG, device="cpu")
    eager = make_sharded_renderer(r.scene, r.config, 2, r.width, r.height)
    assert not isinstance(eager, graphs.FrameGraph)
    monkeypatch.setattr(parallel_mod, "graph_wanted", lambda device: True)
    g = make_sharded_renderer(r.scene, r.config, 2, r.width, r.height)
    assert isinstance(g, graphs.FrameGraph)
    assert g.fn.func is eager.func and g.fn.keywords == eager.keywords
    # Over several devices ("meta" stands in for a second card): one graph
    # per device, of its slabs.
    mesh = make_sharded_renderer(r.scene, r.config, ["cpu", "meta", "cpu"], r.width, r.height)
    assert isinstance(mesh, parallel_mod.MeshFrame) and parallel_mod.frame_graphs(mesh) == list(mesh.fns.values())
    assert [g.fn.keywords["slabs"] for g in mesh.fns.values()] == [(0, 2), (1,)]
    assert all(g.fn.func is parallel_mod.render_slabs for g in mesh.fns.values())


class FakeStream:
    """A stand-in for torch.cuda.Stream that logs waits and entries."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def wait_stream(self, other):
        self.log.append(("wait", self.name, other.name))

    def __repr__(self):
        return self.name


def test_forked_slabs_read_nothing_back(scene, cam, monkeypatch):
    """render_slabs' fork and join (parallel._fork_join, as on a CUDA
    device) with fake streams: each slab renders on a stream of its own
    that waits for the current stream first, the current stream waits for
    every slab's after, each output is marked as used by the current
    stream; with the plain kernels swapped in, the forked frame reads
    nothing back and equals the eager one bit for bit."""
    r = Renderer(scene, CFG, device="cpu")
    uniforms = r.frame_uniforms(cam)
    fn = make_sharded_renderer(r.scene, r.config, 3, r.width, r.height)
    want = fn(r.scene, *uniforms)

    log = []
    current = FakeStream(log, "current")
    made = iter(FakeStream(log, f"slab{i}") for i in range(3))

    @contextlib.contextmanager
    def on_stream(stream):
        log.append(("enter", stream.name))
        yield
        log.append(("exit", stream.name))

    real_fork_join = parallel_mod._fork_join
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: current)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: next(made))
    monkeypatch.setattr(torch.cuda, "stream", on_stream)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, s: log.append(("record", s.name)))
    monkeypatch.setattr(parallel_mod, "_fork_join", lambda calls, device: real_fork_join(calls, torch.device("cuda")))
    guard = Guard()
    _install(monkeypatch, guard)
    with guard.on():
        got = fn(r.scene, *uniforms)
    monkeypatch.undo()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    slabs = [f"slab{i}" for i in range(3)]
    assert log[:9] == [x for s in slabs for x in (("wait", s, "current"), ("enter", s), ("exit", s))]
    assert log[9:12] == [("wait", "current", s) for s in slabs]
    assert log[12:] == [("record", "current")] * 12  # 3 slabs x 4 outputs


def test_graph_raises_on_cpu_inputs():
    calls = []

    def fn(*args):
        calls.append(args)
        return args[0]

    g = graphs.Graph(fn, name="plan")
    for args in ((torch.zeros(3),), (torch.zeros(3), torch.zeros(2)), ()):
        with pytest.raises(ValueError, match="CUDA device"):
            g(*args)
        with kernels.plain_kernels(), pytest.raises(ValueError, match="CUDA device"):
            g(*args)
    assert calls == [] and g.capture_ms is None and g.inputs is None
    assert isinstance(graphs.FrameGraph(fn), graphs.Graph)


class FakeFrameGraph:
    """Records what a tool hands a graph, and calls fn eagerly."""

    def __init__(self, fn, name="graph"):
        self.fn, self.name = fn, name
        self.calls, self.closed = 0, False
        MADE.append(self)

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)

    def close(self):
        self.closed = True


class FakeGraph(FakeFrameGraph):
    """Its first call's inputs become ``inputs``, as a Graph's static
    buffers do; a later call must hand them over."""

    inputs = None

    def __call__(self, *args):
        if self.inputs is None:
            self.inputs = tuple(a.clone() for a in args)
        else:
            assert all(a is b for a, b in zip(args, self.inputs)), f"{self.name}: a call handed other inputs"
        return super().__call__(*args)


MADE: list = []
SMALL = dict(width=128, height=64, frames=2, warmup=1, device="cpu")


@pytest.mark.parametrize("wanted", [True, False])
def test_tools_time_graphs_where_graphs_are_wanted(scene, monkeypatch, wanted):
    """sample_stage_probe.probe times a FrameGraph of each prefix and
    profile_sampler.profile Graphs of plan_tiles and sample_tiles, fed the
    graphs' own input buffers, where graph_wanted holds (faked); both stay
    eager where it does not (on the CPU)."""
    MADE.clear()
    for mod, name, fake in ((sample_stage_probe, "FrameGraph", FakeFrameGraph), (profile_sampler, "Graph", FakeGraph)):
        if wanted:
            monkeypatch.setattr(mod, "graph_wanted", lambda device: True)
        monkeypatch.setattr(mod, name, fake)
    probe = sample_stage_probe.probe(scene, stages=("plan", "sample", "frame"), **SMALL)
    prof = profile_sampler.profile(scene, **SMALL)
    assert list(probe) == ["plan", "sample", "frame"] and prof["tiles"]["windowed"] > 0
    if not wanted:
        assert MADE == []
        return
    assert [g.name for g in MADE] == ["stage plan", "stage sample", "stage frame", "plan", "sample"]
    assert [g.fn.keywords["stage"] for g in MADE[:3]] == ["plan", "sample", None]
    timed = SMALL["warmup"] + SMALL["frames"]
    assert [g.calls for g in MADE] == [timed] * 3 + [1 + timed] * 2 and all(g.closed for g in MADE)
    plan, sample = MADE[3:]
    r = Renderer(scene, RendererConfig(width=128, height=64), device="cpu")
    gbuf_shape = (resolve.A_OUT, 64, 128)
    assert [t.shape for t in plan.inputs] == [gbuf_shape]
    assert [t.shape for t in sample.inputs] == [gbuf_shape, r.scene["atlas"]["page"].shape, (2, 8, 128), (3,)]
