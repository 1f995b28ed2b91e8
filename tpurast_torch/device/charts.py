"""UV charts: connected components of mesh faces under shared vertices.

A copy of tpurast/device/charts.py (the port imports nothing of the
reference package; tests/test_torch_tools.py holds the copy to its
original). glTF meshes duplicate vertices along UV seams (a vertex index
carries ONE uv), so two faces sharing a vertex INDEX are UV-continuous:
the vertex-sharing graph's connected components are exactly the mesh's UV
charts (atlas islands). Host-side only, for UV-layout analysis
(tools/residual_analysis.py): the windowed sampler's page-coordinate
covering needs no charts, so none are computed at scene build.
"""

from __future__ import annotations

import numpy as np


def face_charts(faces: np.ndarray, n_faces: int, n_vertices: int) -> np.ndarray:
    """Per-face chart id (dense, 0..n_charts-1): connected components of
    the vertex-sharing graph. `faces` is (Fp, 3) global vertex indices;
    only the first `n_faces` rows are real (padding gets chart 0).
    """
    if n_faces == 0:
        return np.zeros(faces.shape[0], dtype=np.int32)
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    f = np.asarray(faces[:n_faces], dtype=np.int64)
    # Two edges per face (v0-v1, v1-v2) connect all three corners.
    rows = np.concatenate([f[:, 0], f[:, 1]])
    cols = np.concatenate([f[:, 1], f[:, 2]])
    g = coo_matrix(
        (np.ones(rows.shape[0], np.int8), (rows, cols)),
        shape=(n_vertices, n_vertices),
    )
    _, vert_label = connected_components(g, directed=False)
    roots = vert_label[f[:, 0]]
    _, dense = np.unique(roots, return_inverse=True)
    out = np.zeros(faces.shape[0], dtype=np.int32)
    out[:n_faces] = dense.astype(np.int32)
    return out
