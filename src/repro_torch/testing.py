"""Test-support shims: hypothesis re-exports with a skip-based fallback (the
port's own copy of ``src/repro/testing.py``).

The property-based tests use ``hypothesis``, a dev-only dependency.
Importing ``given``/``settings``/``strategies`` from here instead of from
``hypothesis`` keeps the suite collectable in minimal environments: when
hypothesis is absent, the property tests are decorated with
``pytest.mark.skip`` and every example-based test in the same module still
runs.
"""

from __future__ import annotations

try:
    from hypothesis import given, settings, strategies  # noqa: F401

    HAS_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised only without hypothesis
    HAS_HYPOTHESIS = False

    class _StrategyStub:
        """Stands in for ``hypothesis.strategies``: any attribute is a factory
        returning an inert placeholder, so ``st.integers(0, 1)`` etc. evaluate
        at module import without the real library."""

        def __getattr__(self, name):
            def factory(*args, **kwargs):
                return None

            return factory

    strategies = _StrategyStub()

    def settings(*args, **kwargs):
        """No-op decorator (accepts and ignores hypothesis settings)."""

        def decorate(fn):
            return fn

        return decorate

    def given(*args, **kwargs):
        """Mark the property test as skipped instead of generating examples."""
        import pytest

        def decorate(fn):
            return pytest.mark.skip(reason="hypothesis not installed")(fn)

        return decorate

__all__ = ["given", "settings", "strategies", "HAS_HYPOTHESIS"]
