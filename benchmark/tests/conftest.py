"""The benchmark's CPU tests import it as the package ``benchmark`` of the
checkout."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
