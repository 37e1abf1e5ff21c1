"""Math layer: graph algorithms, robust linear solvers, probability tests.

Batched re-design of `src/theia/math/` — the sparse
direct solvers (Eigen SimplicialLDLT, `matrix/sparse_cholesky_llt.h:57`)
become operator-based conjugate-gradient solves whose matvecs are
gather/segment-sum kernels, and the ADMM solvers (`l1_solver.h:87`,
`qp_solver.h:65`) become fixed-iteration jitted loops.
"""

from . import graph  # noqa: F401
from . import qp  # noqa: F401
from . import sdp  # noqa: F401
from .l1 import admm_l1, irls_solve  # noqa: F401
from .qp import solve_box_qp, solve_constrained_l1  # noqa: F401
from .sdp import SDPSolverOptions, riemannian_staircase, solve_block_sdp  # noqa: F401
from .sprt import sequential_probability_ratio_test  # noqa: F401
