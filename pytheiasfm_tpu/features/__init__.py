"""On-device feature extraction.

The reference deliberately delegates feature extraction to Python CV
libraries (`README.md:15-18`; its own C++ extraction path is commented out,
`feature_extractor.cc:123-140`). This package goes one step further in the
Accelerator direction: a pure-JAX scale-space detector/descriptor that runs
the Gaussian pyramid and descriptor math on the accelerator, feeding the
matching layer without any OpenCV dependency.
"""

from .sift import SiftParams, detect_and_describe, load_grayscale  # noqa: F401
