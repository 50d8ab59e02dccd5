"""`python -m voxelslam_tpu_torch` (port of `voxelslam_tpu/__main__.py`)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
