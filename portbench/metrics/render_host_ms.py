"""render_host_ms (ms): the host's time inside Renderer.render_with_uniforms
a frame (the harness's clock around the call; the compiled frame's
uniform copies, graph replay and output clones), mean over the window."""

UNIT = "ms"


def read(run):
    return run.window.render_host_ms
