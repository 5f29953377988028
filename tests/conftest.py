"""Shared test fixtures.

``hypothesis`` is an optional dev dependency (requirements-dev.txt): when it
is absent, only the property-based tests skip -- the deterministic tests in
the same modules still run (a plain ``pytest.importorskip`` at module level
would throw those away too).

``forced8_run`` runs a source snippet in a child interpreter with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``: multi-device tests
(sharded serving, distributed train) need a mesh, but forcing host devices
must not leak into the main pytest process, which every other test expects
to hold exactly one real CPU device.
"""
import os
import subprocess
import sys
import textwrap

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def forced8_run():
    """snippet -> stdout, executed under an 8-device forced host platform."""

    def run(snippet: str, timeout: int = 420, extra_env=None) -> str:
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = os.path.join(_REPO, "src")
        env.update(extra_env or {})
        out = subprocess.run([sys.executable, "-c", textwrap.dedent(snippet)],
                             capture_output=True, text=True, timeout=timeout,
                             env=env)
        assert out.returncode == 0, out.stderr[-4000:]
        return out.stdout

    return run

try:
    from hypothesis import given, settings, strategies as st  # noqa: F401
    HAVE_HYPOTHESIS = True
except ImportError:                       # pragma: no cover - env-dependent
    HAVE_HYPOTHESIS = False

    class _StrategyStub:
        """Absorbs ``st.integers(...)``-style calls at decoration time."""

        def __getattr__(self, _name):
            return lambda *a, **k: None

    st = _StrategyStub()

    def given(*_args, **_kwargs):
        def deco(fn):
            @pytest.mark.skip(reason="hypothesis not installed "
                                     "(pip install -r requirements-dev.txt)")
            def stub():
                pass
            stub.__name__ = fn.__name__
            stub.__doc__ = fn.__doc__
            return stub
        return deco

    def settings(*_args, **_kwargs):
        return lambda fn: fn


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips where there is "
                   "none (the port's CUDA kernels have no CPU mode)")
