"""nuScenes map-expansion parser (no devkit).

The port's own copy of ``v2x_sim_tpu/datasets/nuscenes_map.py`` (numpy
only): parses ``maps/expansion/{location}.json`` into per-layer polygon
lists (global frame) and maps nuScenes layer names onto the seg classes
(``Config.seg_class_names``).

Supported record shapes (the parser is permissive because V2X-Sim is a
CARLA export in nuScenes clothing):

  * canonical expansion schema: ``node`` rows (token, x, y), ``polygon``
    rows (token, exterior_node_tokens, holes), and layer rows referencing
    them via ``polygon_token`` or ``polygon_tokens`` (drivable_area);
  * inline fallback: layer rows carrying an ``exterior`` vertex list
    directly, as simplified CARLA exports and the JAX package's synthetic
    writer emit.

Polygon holes are ignored (a hole smaller than a BEV cell is invisible;
larger ones are rare in drivable areas and err toward over-painting the
coarser class, which the later paint passes correct).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: nuScenes / CARLA layer name -> Config.seg_class_names entry.
NUSC_LAYER_TO_CLASS = {
    "drivable_area": "road",
    "road_segment": "road",
    "road_block": "road",
    "lane": "road",
    "road": "road",
    "walkway": "sidewalk",
    "ped_crossing": "sidewalk",
    "sidewalk": "sidewalk",
    "terrain": "terrain",
    "building": "building",
    "vegetation": "vegetation",
}

#: Paint order, coarse -> fine: later classes overwrite earlier ones
#: (utils/mapping.py::build_seg_labels paints in iteration order; pedestrians
#: and vehicles go on top, handled by the caller).
PAINT_ORDER = ("terrain", "vegetation", "road", "sidewalk", "building")


class NuScenesMapExpansion:
    """One location's map-expansion file -> layer polygons (global frame)."""

    def __init__(self, dataroot: str, location: str):
        self.location = location
        path = os.path.join(dataroot, "maps", "expansion", f"{location}.json")
        with open(path) as f:
            data = json.load(f)

        nodes: Dict[str, Tuple[float, float]] = {
            r["token"]: (float(r["x"]), float(r["y"]))
            for r in data.get("node", [])
        }
        polygons: Dict[str, np.ndarray] = {}
        for r in data.get("polygon", []):
            toks = r.get("exterior_node_tokens", [])
            pts = [nodes[t] for t in toks if t in nodes]
            if len(pts) >= 3:
                polygons[r["token"]] = np.asarray(pts, np.float64)

        self.layer_polys: Dict[str, List[np.ndarray]] = {}
        for layer in data:
            if layer in ("node", "polygon") or layer not in NUSC_LAYER_TO_CLASS:
                continue
            out: List[np.ndarray] = []
            for r in data[layer]:
                toks = r.get("polygon_tokens")
                if toks is None:
                    tok = r.get("polygon_token")
                    toks = [tok] if tok else []
                for t in toks:
                    if t in polygons:
                        out.append(polygons[t])
                ext = r.get("exterior")
                if ext and len(ext) >= 3:
                    out.append(np.asarray(ext, np.float64))
            if out:
                self.layer_polys.setdefault(layer, []).extend(out)

    def class_polygons(
        self, seg_class_names: Sequence[str]
    ) -> List[Tuple[str, List[np.ndarray]]]:
        """[(seg class, [(N,2) global-frame polygon, ...])] in paint order."""
        by_class: Dict[str, List[np.ndarray]] = {}
        for layer, polys in self.layer_polys.items():
            cls = NUSC_LAYER_TO_CLASS[layer]
            if cls in seg_class_names:
                by_class.setdefault(cls, []).extend(polys)
        return [(c, by_class[c]) for c in PAINT_ORDER if c in by_class]


def transform_polygons(
    class_polys: Sequence[Tuple[str, Sequence[np.ndarray]]],
    local_from_global: np.ndarray,
    extents: Tuple[Tuple[float, float], Tuple[float, float]],
) -> List[Tuple[str, List[np.ndarray]]]:
    """Global-frame class polygons -> one agent's frame, bbox-culled.

    Args:
      local_from_global: (4, 4) sensor_from_global transform.
      extents: ((x0, x1), (y0, y1)) agent-frame BEV extents; polygons whose
        transformed bbox misses the extents are dropped (maps are city-sized,
        the BEV window is 64 m).
    """
    r = local_from_global[:2, :2]
    t = local_from_global[:2, 3]
    (x0, x1), (y0, y1) = extents
    out: List[Tuple[str, List[np.ndarray]]] = []
    for cls, polys in class_polys:
        kept = []
        for poly in polys:
            local = poly @ r.T + t
            if (
                local[:, 0].max() < x0
                or local[:, 0].min() > x1
                or local[:, 1].max() < y0
                or local[:, 1].min() > y1
            ):
                continue
            kept.append(local)
        if kept:
            out.append((cls, kept))
    return out
