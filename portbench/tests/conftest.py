"""Shared settings of the benchmark's CPU tests: a cell cut to a tiny
frame, a short ring (a change of shot every 6 frames) and a small sample,
so that a whole run drives the port's plain versions in seconds."""

import pytest
import torch

# the plain versions run thousands of tiny ops a pair: one thread each,
# so that several test processes do not oversubscribe the cores
torch.set_num_threads(1)

SMALL = {"config": {"width": 96, "height": 64},
         "ring": {"frames_per_shot": 6, "max_pan_px": 4, "boxes": 2,
                  "box_min_px": 8, "box_max_px": 24, "box_max_speed_px": 4,
                  "base_cell_px": 32, "detail_cell_px": 4},
         "sample": {"pairs": 4, "from_first": 20, "cut_pairs": 2},
         "traffic": {"warm_calls": 2}}


@pytest.fixture
def small():
    return SMALL


def calls_for(cell: str) -> int:
    """Calls of a small window: 32 pairs."""
    return 4 if cell.endswith("group8") else 32
