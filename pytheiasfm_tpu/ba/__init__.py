"""Bundle adjustment: dense-Schur matmul solver (small/medium problems) +
LM with implicit Schur complement + PCG (large problems)."""

from . import dense_schur, iterative_schur, lm, losses  # noqa: F401
from .dense_schur import DENSE_SCHUR_MAX_CAMERAS, bundle_adjust_dense  # noqa: F401
from .iterative_schur import bundle_adjust_iterative  # noqa: F401
from .lm import (  # noqa: F401
    BundleAdjustmentOptions,
    BundleAdjustmentSummary,
    LinearSolverType,
    bundle_adjust,
)
from .losses import LossFunctionType  # noqa: F401
