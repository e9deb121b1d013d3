"""The program cache index.

The programs themselves live in the engine (``fed.engine``'s and
``fed.model_engine``'s ``lru_cache``'d program constructors, each program
remembering the argument signatures it has run; the CUDA kernels are
built once per source into ``kernels/_build/``).  What the engine does not
know is the serving question: **will this admission run a program at a
signature it has not run before, and how often do we win?**
:class:`ProgramCache` is that index: it tracks every
:func:`~repro_torch.api.lowering.program_key` ever dispatched and
classifies each admission warm (every chunk program seen before → zero
new ``TraceEvent``s in the engine's ledger, test-enforced) or cold,
feeding the hit/miss counters ``ServiceStats`` reports.  It indexes keys
only: the port captures no CUDA graph, so there is nothing else to cache.

The registry is process-scoped by default: it is class-shared, so every
service instance in a process sees programs warmed by any other, as the
engine's program caches it fronts are process-level too.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

__all__ = ["ProgramCache"]


class ProgramCache:
    """Hit/miss index over dispatched program shapes (see module doc)."""

    _SHARED: Dict[tuple, int] = {}

    def __init__(self, shared: bool = True,
                 persist_dir: Optional[str] = None):
        self._seen: Dict[tuple, int] = (ProgramCache._SHARED if shared
                                        else {})
        self.hits = 0
        self.misses = 0
        if persist_dir is not None:
            self._enable_disk_cache(persist_dir)

    @staticmethod
    def _enable_disk_cache(path: str) -> bool:
        """Always ``False``: the port has no compiled executables to keep
        across processes (the reference points jax's compilation cache
        at ``path``).  Its eager programs compile nothing, and its CUDA
        kernels are already built once per source into
        ``kernels/_build/``, keyed by a hash of the source.  The key
        registry stays process-scoped, as in the reference: a fresh
        process has run no program, so no key may be pre-marked warm."""
        return False

    def __len__(self) -> int:
        return len(self._seen)

    def __contains__(self, key: tuple) -> bool:
        return key in self._seen

    def admit(self, keys: Iterable[tuple]) -> Tuple[int, int]:
        """Record one admission's program keys; returns ``(hits,
        misses)`` over the keys.  ``misses == 0`` is the *warm admission*
        contract: every program this bucket will dispatch has already run
        at its signature in this process, so running it must add zero
        ``TraceEvent``s to the engine's ledger."""
        hits = misses = 0
        for key in keys:
            if key in self._seen:
                self._seen[key] += 1
                hits += 1
            else:
                self._seen[key] = 1
                misses += 1
        self.hits += hits
        self.misses += misses
        return hits, misses

    def use_count(self, key: tuple) -> int:
        """How many admissions have dispatched ``key`` (0 = never)."""
        return self._seen.get(key, 0)

    @classmethod
    def clear_shared(cls) -> None:
        """Drop the process-shared registry (tests only: the engine's
        programs it fronts are not cleared, so a cleared index
        under-reports warmth but never breaks the warm ⇒ no-event
        contract)."""
        cls._SHARED.clear()
