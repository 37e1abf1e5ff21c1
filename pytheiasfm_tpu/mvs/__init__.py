"""Multi-view-stereo support (parity: `/root/reference/src/theia/mvs/`).

The reference computes depth maps in Python (torch) and only hosts view
selection in C++ (`mvs/view_selection_mvsnet.h:50`); this package provides
the device-batched equivalent.
"""

from .view_selection import pairwise_view_scores, view_selection_mvsnet

__all__ = ["view_selection_mvsnet", "pairwise_view_scores"]
