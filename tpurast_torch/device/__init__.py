"""Scene residency for the port (host build with numpy, upload with torch).

  charts.py   — UV charts of a mesh (host only; the analysis tools)
  pages.py    — texture pages (tpurast/device/pages.py without device())
  scene.py    — the DeviceScene record, build_scene, load_demo_scene,
                upload / from_numpy, the procedural smoke scene
  textures.py — the quad-row atlas build (tpurast/device/textures.py
                without device()), its upload in the four texel dtypes
                and the texture_dtype="auto" rule
"""
