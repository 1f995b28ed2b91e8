"""setup_scene_s (s): the program's scene build (device/scene.py build_scene,
the setup.scene span: textures decoded, atlas and pages built), host clock."""

from portbench import program_trace

UNIT = "s"


def read(run):
    return program_trace.setup_span_s(run, "setup.scene")
