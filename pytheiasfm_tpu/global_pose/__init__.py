"""Global pose estimation: rotation averaging + position averaging.

Batched re-design of
`/root/reference/src/theia/sfm/global_pose_estimation/`. Every estimator is
a pure function over flat edge arrays (from `ViewGraph.edge_arrays`); the
sparse linear algebra is operator-form CG with gather/segment-sum matvecs.
"""

from .rotation_estimator import (  # noqa: F401
    GlobalRotationEstimatorType,
    estimate_rotations,
    irls_rotation_refine,
    linear_rotation_averaging,
    nonlinear_rotation_averaging,
    orientations_from_maximum_spanning_tree,
    robust_rotation_averaging,
)
from .position_estimator import (  # noqa: F401
    GlobalPositionEstimatorType,
    estimate_positions,
    least_unsquared_deviation_positions,
    linear_triplet_positions,
    nonlinear_positions,
)
from .filters import (  # noqa: F401
    filter_view_pairs_from_orientation,
    filter_view_graph_cycles_by_rotation,
    filter_view_pairs_from_relative_translation,
)
