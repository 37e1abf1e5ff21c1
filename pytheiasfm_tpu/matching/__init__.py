"""Feature matching — layer 8 of the reference
(`/root/reference/src/theia/matching/`, SURVEY §2.7).

Descriptor matching is matmul-shaped: every image pair's distance matrix
is one matmul; Lowe's ratio and the symmetric cross-check are row/column
top-2 reductions fused around it. Pairs batch along a leading axis and
shard across devices.
"""

from .types import (  # noqa: F401
    FeatureCorrespondence,
    IndexedFeatureMatch,
    Keypoint,
    KeypointsAndDescriptors,
)
from .options import FeatureMatcherOptions  # noqa: F401
from .brute_force import match_descriptor_pair, match_descriptors_batch  # noqa: F401
from .matcher import BruteForceFeatureMatcher, FeatureMatcher  # noqa: F401
from .database import (  # noqa: F401
    FeaturesAndMatchesDatabase,
    InMemoryFeaturesAndMatchesDatabase,
)
from .graph_match import graph_match  # noqa: F401
from .guided_epipolar import GuidedEpipolarMatcher, guided_epipolar_match  # noqa: F401
from .fisher_vector import FisherVectorExtractor  # noqa: F401
