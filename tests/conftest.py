import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# The property suite needs hypothesis (the `dev` extra in pyproject.toml);
# skip collection rather than erroring when it isn't installed.
collect_ignore = []
if importlib.util.find_spec("hypothesis") is None:
    collect_ignore.append("test_property.py")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the PyTorch port's kernels); "
        "skips where there is none")
