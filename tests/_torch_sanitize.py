"""Arms the port's runtime mutation sanitizer for the port's scheduler tests.

The root ``conftest.py`` arms the JAX package's sanitizer under
``REPRO_SANITIZE=1``; the port has its own
(``repro_torch.analysis.sanitizer``), and a scheduler test module takes it by
importing the autouse fixture::

    from _torch_sanitize import port_sanitizer  # noqa: F401

Under ``REPRO_SANITIZE=1`` every port ``NetworkGraph`` and ``JRBAEngine``
the module builds is audited; without it the fixture does nothing.
"""
import contextlib

import pytest

from repro_torch.analysis import sanitizer


@contextlib.contextmanager
def armed():
    """The port's sanitizer installed while the block runs, when
    ``REPRO_SANITIZE`` asks for it; yields whether it was."""
    if not sanitizer.enabled():
        yield False
        return
    uninstall = sanitizer.install()
    try:
        yield True
    finally:
        uninstall()


@pytest.fixture(scope="module", autouse=True)
def port_sanitizer():
    with armed() as on:
        yield on
