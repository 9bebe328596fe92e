import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """The tiny cells, written where the harness was not told of them."""
    from benchmark.tests.tiny import write_tiny

    return write_tiny(tmp_path_factory.mktemp("tiny"))
