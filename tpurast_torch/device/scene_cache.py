"""Host-side scene cache and the bench's scenes by name.

Counterpart of tpurast/device/scene_cache.py. Building a porsche-class
scene costs minutes of host CPU (BC7 decode of full 2048^2 mip chains +
atlas/page packing). A DeviceScene is pure numpy until ``upload``, so it
pickles once and reloads in seconds. Build time is never part of the
bench's timed loop (tpurast_torch/cli.py times only render + read-back),
so the cache changes iteration latency, not any reported number.

Cache key = scene name + loader keyword arguments + CACHE_VERSION, in a
directory of the port's own (``.scene_cache/tpurast_torch`` beside the
package unless TPURAST_TORCH_SCENE_CACHE_DIR names another): a pickle
names its class by module, so the reference's pickles of
tpurast.device.scene.DeviceScene and these can never stand in for each
other. Bump CACHE_VERSION when DeviceScene gains fields the pickle must
carry or when asset decoding changes. Opt out with
TPURAST_TORCH_SCENE_CACHE=0. Only files this module wrote are unpickled.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pathlib
import pickle

log = logging.getLogger("tpurast_torch.device")

CACHE_VERSION = 1

#: The bench's scenes. "orbit" is procedural and needs no data directory.
SCENES = ("demo", "porsche_class", "hdr", "dragons64", "orbit")


def cache_dir() -> pathlib.Path:
    default = pathlib.Path(__file__).resolve().parent.parent.parent / ".scene_cache" / "tpurast_torch"
    return pathlib.Path(os.environ.get("TPURAST_TORCH_SCENE_CACHE_DIR", default))


def load_scene_cached(name: str, loader, *args, **kwargs):
    """Memoize `loader(*args, **kwargs)` on disk under `name` and the
    keyword arguments."""
    if os.environ.get("TPURAST_TORCH_SCENE_CACHE", "1") != "1":
        return loader(*args, **kwargs)
    key = hashlib.sha256(repr(sorted(kwargs.items())).encode()).hexdigest()[:12] if kwargs else "default"
    path = cache_dir() / f"{name}.{key}.v{CACHE_VERSION}.pkl"
    if path.exists():
        log.info("scene cache hit: %s", path)
        with open(path, "rb") as fh:
            return pickle.load(fh)
    scene = loader(*args, **kwargs)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    with open(tmp, "wb") as fh:
        pickle.dump(scene, fh, protocol=5)
    os.replace(tmp, path)
    return scene


def load_named_scene(name: str, data_dir: str | None = None, **kwargs):
    """Load one of the bench's scenes by name, cached. ``data_dir`` is the
    reference's data directory (every scene but "orbit" reads it; a
    missing one raises FileNotFoundError naming it); kwargs go to the
    loader ("orbit": build_orbit_scene's seed and sizes)."""
    from tpurast_torch.device import scene as scene_mod

    if name == "orbit":
        return load_scene_cached(name, scene_mod.build_orbit_scene, **kwargs)
    loaders = {
        "demo": scene_mod.load_demo_scene,
        "porsche_class": scene_mod.load_porsche_class_scene,
        "hdr": scene_mod.load_hdr_scene,
        "dragons64": lambda d, **kw: scene_mod.load_instanced_dragons(d, 64, **kw),
    }
    if name not in loaders:
        raise ValueError(f"unknown scene {name!r}: expected one of {SCENES}")
    if data_dir is None or not os.path.isdir(data_dir):
        raise FileNotFoundError(f"scene {name!r} reads the data directory {data_dir!r}, which does not exist")
    return load_scene_cached(name, loaders[name], data_dir, **kwargs)
