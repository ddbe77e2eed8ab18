"""The paper's Table 2: a frozen copy of the rows the port's datasets use.

Saule et al., "Parallel Space-Time Kernel Density Estimation", arXiv:1705.09366
(2017), Table 2: the point count, the grid in voxels at unit resolution and
the bandwidths in voxels of each instance. Copied from
``repro_torch/core/datasets.py::INSTANCES``; ``approx`` marks the cells that
were reconstructed from the paper's own relations where the source text is
garbled, and ``layout_seed`` is the seed the port's generator gives the
dataset.
"""
from __future__ import annotations

from typing import Dict, NamedTuple


class Row(NamedTuple):
    n: int
    Gx: int
    Gy: int
    Gt: int
    Hs: int
    Ht: int
    layout_seed: int
    approx: bool = False


ROWS: Dict[str, Row] = {
    "Dengue_Lr-Lb": Row(11056, 148, 194, 728, 3, 1, 1),
    "Dengue_Lr-Hb": Row(11056, 148, 194, 728, 25, 1, 1),
    "Dengue_Hr-Lb": Row(11056, 294, 386, 728, 6, 1, 1, True),
    "Dengue_Hr-Hb": Row(11056, 294, 386, 728, 50, 1, 1, True),
    "Dengue_Hr-VHb": Row(11056, 294, 386, 728, 50, 14, 1),
    "PollenUS_Lr-Lb": Row(588189, 131, 61, 84, 2, 3, 2),
    "PollenUS_Hr-Lb": Row(588189, 651, 301, 84, 10, 3, 2),
    "PollenUS_Hr-Mb": Row(588189, 651, 301, 84, 25, 7, 2),
    "PollenUS_Hr-Hb": Row(588189, 651, 301, 84, 50, 14, 2, True),
    "PollenUS_VHr-Lb": Row(588189, 6501, 3001, 84, 100, 3, 2),
    "PollenUS_VHr-VLb": Row(588189, 6501, 3001, 84, 50, 3, 2, True),
    "Flu_Lr-Lb": Row(31478, 117, 308, 851, 1, 1, 3),
    "Flu_Lr-Hb": Row(31478, 117, 308, 851, 3, 3, 3, True),
    "Flu_Mr-Lb": Row(31478, 233, 615, 1985, 2, 3, 3),
    "Flu_Mr-Hb": Row(31478, 233, 615, 1985, 4, 7, 3),
    "Flu_Hr-Lb": Row(31478, 581, 1536, 5951, 5, 7, 3),
    "Flu_Hr-Hb": Row(31478, 581, 1536, 5951, 10, 21, 3),
    "eBird_Lr-Lb": Row(291990435, 357, 721, 2435, 2, 3, 4),
    "eBird_Lr-Hb": Row(291990435, 357, 721, 2435, 6, 5, 4),
    "eBird_Hr-Lb": Row(291990435, 1781, 3601, 2435, 10, 3, 4),
    "eBird_Hr-Hb": Row(291990435, 1781, 3601, 2435, 30, 5, 4),
}
