"""Asset ingest: glTF-binary scenes, KTX2 textures, BC block decode.

The reference's equivalent layer is zgltf (pure-Zig glTF parse, used at
src/Renderer.zig:680-682) plus libktx (KTX2 parse + Zstandard inflate +
per-mip iteration, src/wgpu.zig:130-194). Here both are first-party:
:mod:`tpurast_torch.assets.gltf` and :mod:`tpurast_torch.assets.ktx2`, with BC7/BC6H/
BC4 block decoding in :mod:`tpurast_torch.assets.bcdec` (numpy reference
implementation; a C++ fast path lives in tpurast_torch/native/).
"""

from tpurast_torch.assets.gltf import GltfModel, load_glb  # noqa: F401
from tpurast_torch.assets.ktx2 import Ktx2Texture, load_ktx2  # noqa: F401
