"""Property-testing surface: ``hypothesis`` when available, else a
minimal API-compatible fallback.

The test suite writes property tests against the hypothesis idiom::

    from repro_torch.testing.proptest import (given, settings,
                                              strategies as st)

    @settings(max_examples=25, deadline=None)
    @given(n=st.integers(1, 100), x=st.floats(0.0, 1.0))
    def test_prop(n, x): ...

With ``hypothesis`` installed those names *are* hypothesis's (full
shrinking, database, profiles).  Without it, the fallback below drives
the same tests with deterministic pseudo-random examples — no shrinking,
but the failing example is printed and the seed is derived from the test
name, so failures reproduce exactly across runs and machines.  This is
the repo's "stub optional deps, never skip coverage" pattern: property
tests assert real invariants (solver feasibility, padding bit-identity,
grid round-trips) that must run even on images without the optional dep.

Profiles: ``load_profile_from_env()`` honours ``HYPOTHESIS_PROFILE``
(used by CI's quick property job) in both modes — under real hypothesis
it registers/loads ``ci`` (more examples) and ``dev`` profiles; the
fallback scales its default example count the same way.  Tests that pin
``max_examples`` explicitly keep their pinned count (hypothesis
semantics: the decorator wins over the profile), so the profile governs
the tests that leave it unset.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

PROFILES = {"default": 20, "dev": 10, "ci": 100}

try:                                                  # pragma: no cover
    from hypothesis import given, settings, strategies  # noqa: F401
    HAVE_HYPOTHESIS = True

    def load_profile_from_env() -> str:
        """Register the repo's profiles and load ``HYPOTHESIS_PROFILE``."""
        for name, n in PROFILES.items():
            settings.register_profile(name, max_examples=n, deadline=None)
        profile = os.environ.get("HYPOTHESIS_PROFILE", "default")
        settings.load_profile(profile if profile in PROFILES else "default")
        return profile

except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False
    _ACTIVE = {"profile": "default"}

    def load_profile_from_env() -> str:
        profile = os.environ.get("HYPOTHESIS_PROFILE", "default")
        _ACTIVE["profile"] = profile if profile in PROFILES else "default"
        return _ACTIVE["profile"]

    class SearchStrategy:
        """A draw rule: ``example(rng)`` produces one value."""

        def __init__(self, draw):
            self._draw = draw

        def example(self, rng: np.random.Generator):
            return self._draw(rng)

        def map(self, fn) -> "SearchStrategy":
            return SearchStrategy(lambda rng: fn(self._draw(rng)))

    class _Strategies:
        """The ``hypothesis.strategies`` subset the suite draws from."""

        @staticmethod
        def integers(min_value: int, max_value: int) -> SearchStrategy:
            return SearchStrategy(
                lambda rng: int(rng.integers(min_value, max_value + 1)))

        @staticmethod
        def floats(min_value: float, max_value: float) -> SearchStrategy:
            return SearchStrategy(
                lambda rng: float(rng.uniform(min_value, max_value)))

        @staticmethod
        def booleans() -> SearchStrategy:
            return SearchStrategy(lambda rng: bool(rng.integers(0, 2)))

        @staticmethod
        def sampled_from(seq) -> SearchStrategy:
            seq = list(seq)
            return SearchStrategy(
                lambda rng: seq[int(rng.integers(len(seq)))])

        @staticmethod
        def lists(elements: SearchStrategy, min_size: int = 0,
                  max_size: int = 10) -> SearchStrategy:
            def draw(rng):
                n = int(rng.integers(min_size, max_size + 1))
                return [elements.example(rng) for _ in range(n)]
            return SearchStrategy(draw)

        @staticmethod
        def tuples(*parts: SearchStrategy) -> SearchStrategy:
            return SearchStrategy(
                lambda rng: tuple(p.example(rng) for p in parts))

    strategies = _Strategies()

    def settings(max_examples=None, deadline=None, **_ignored):
        """Pin a test's example count (``deadline`` accepted, unused)."""
        def deco(fn):
            if max_examples is not None:
                fn._proptest_max_examples = max_examples
            return fn
        return deco

    def given(**named_strategies):
        """Run the wrapped test once per drawn example.

        The rng seed derives from the test's qualified name, so the
        example sequence is stable across runs; the active profile sets
        the example count unless the test pinned one via ``settings``.
        On failure the falsifying example is printed and the original
        exception re-raised (no shrinking).
        """
        def deco(fn):
            def wrapper(*args, **kwargs):
                # settings() may sit above (attribute on wrapper) or
                # below (attribute on fn) this decorator — honour both
                n = getattr(wrapper, "_proptest_max_examples",
                            getattr(fn, "_proptest_max_examples", None))
                if n is None:
                    n = PROFILES[_ACTIVE["profile"]]
                seed = zlib.crc32(fn.__qualname__.encode())
                rng = np.random.default_rng(seed)
                for i in range(n):
                    example = {k: s.example(rng)
                               for k, s in named_strategies.items()}
                    try:
                        fn(*args, **{**kwargs, **example})
                    except Exception:
                        print(f"proptest: falsifying example "
                              f"({fn.__qualname__}, run {i}): {example!r}")
                        raise
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            wrapper._proptest_inner = fn
            return wrapper
        return deco
