"""WildScenes semantic-segmentation metadata.

Own copy of ``monoforce_tpu/datasets/wildscenes.py`` (the port imports
nothing of the JAX package).

Reference parity: monoforce/src/monoforce/datasets/wildscenes.py — the
16-class WildScenes table (public dataset constants) used to separate rigid
from soft terrain when building terrain heightmap labels.  Stored compactly
as "cidx,r,g,b,name" rows and expanded on import into the same METAINFO
layout the reference exposes.
"""

_ROWS = [
    "255,0,0,0,unlabelled",
    "0,230,25,75,bush",
    "1,60,180,75,dirt",
    "2,0,128,128,fence",
    "3,128,128,128,grass",
    "4,145,30,180,gravel",
    "5,128,128,0,log",
    "6,255,225,25,mud",
    "7,250,190,190,other-object",
    "8,70,240,240,other-terrain",
    "9,170,255,195,rock",
    "10,0,0,128,sky",
    "11,170,110,40,structure",
    "12,210,245,60,tree-foliage",
    "13,240,50,230,tree-trunk",
    "14,0,130,200,water",
]


def _parse(row):
    cidx, r, g, b, name = row.split(",", 4)
    return int(cidx), (int(r), int(g), int(b)), name


_parsed = [_parse(r) for r in _ROWS]

METAINFO = {
    "classes": tuple(name for _, _, name in _parsed),
    "palette": [color for _, color, _ in _parsed],
    "cidx": [cidx for cidx, _, _ in _parsed],
}

CLASS_TO_CIDX = {name: cidx for cidx, _, name in _parsed}
CIDX_TO_COLOR = {cidx: color for cidx, color, _ in _parsed}


def rigid_classes(soft_classes):
    """All classes not listed as soft/traversable (lss_cfg soft_classes)."""
    return [c for c in METAINFO["classes"] if c not in soft_classes]


__all__ = ["METAINFO", "CLASS_TO_CIDX", "CIDX_TO_COLOR", "rigid_classes"]
