"""Scene residency for the port (host build with numpy, upload with torch).

  pages.py    — texture pages (tpurast.device.pages.build_pages without jax)
  scene.py    — build_scene, load_demo_scene, upload / from_numpy, the
                procedural smoke scene
  textures.py — the quad-row atlas upload in the four texel dtypes and
                the texture_dtype="auto" rule
"""
