"""setup_upload_s (s): the scene's upload to the card (device/scene.py
upload, the setup.upload span: the page, and the quad rows where the path
reads them), host clock."""

from portbench import program_trace

UNIT = "s"


def read(run):
    return program_trace.setup_span_s(run, "setup.upload")
