"""A ``tmp_path`` for the port's tests that is removed when its test ends.

pytest keeps every test's directory until the session ends (and the last
three sessions' after that). The engines these tests open each reserve a
32 MiB commit log segment (fallocate), one per package, so kept
directories cost about a gigabyte for the port's tests alone and add to
the whole suite's disk footprint. Import the fixture into a test module
to shadow pytest's own there:

    from torch_tmp import tmp_path  # noqa: F401
"""
from __future__ import annotations

import shutil

import pytest


def remove(path) -> None:
    """Remove a test's directory; a file still open elsewhere is left."""
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    remove(tmp_path)
