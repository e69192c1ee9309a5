"""`python -m emg3d_tpu_torch` entry point (reference emg3d/__main__.py)."""

import sys

from emg3d_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
