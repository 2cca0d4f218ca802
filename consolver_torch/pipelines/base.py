"""The base of every model family's pipeline: what the serving engines read
of a family (:mod:`consolver_torch.serve` reads nothing else, so that a new
family adds no code there), and the program cache.

A program is a denoise function of one signature, built on first use.  The
learnable solver's runs the step loop with the policy and returns
``(latents, trajectory)``; any other solver is a training-free baseline
whose program returns ``(latents, None)``; ``deterministic`` forks only the
learnable program (a baseline has no policy).  A family supplies only the
functions that make its programs: its denoiser and its ladder.
"""

from __future__ import annotations

import copy
import types
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from consolver_torch.device import resolve_device


class Pipeline:
    """``MODULES``: the model attributes a copy on another device copies
    (``serve.make_replicas``; None values are skipped).  ``LEARNABLE_SOLVER``:
    the solver whose program holds the policy.  ``TENSOR_PARALLEL``: the
    model attribute a mesh's model axis splits and its
    :mod:`consolver_torch.dist.tp` rules, or None: one card per engine."""

    MODULES: Tuple[str, ...] = ()
    LEARNABLE_SOLVER: str = ""
    TENSOR_PARALLEL: Optional[Tuple[str, Sequence[Tuple[str, str]]]] = None

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._programs: Dict[tuple, Callable] = {}

    @property
    def latent_channels(self) -> int:
        """Channels of the initial noise, NHWC."""
        raise NotImplementedError

    def tokenize(self, prompts: Sequence[str], max_length: Optional[int] = None):
        """The prompts' ids as the pipeline's call takes them."""
        raise NotImplementedError

    def is_learnable(self, solver: str) -> bool:
        return solver == self.LEARNABLE_SOLVER

    @property
    def programs(self) -> Mapping[tuple, Callable]:
        """The cached programs by key (read-only)."""
        return types.MappingProxyType(self._programs)

    def replace(self, **attrs) -> "Pipeline":
        """A shallow copy with ``attrs`` swapped in and an empty program
        cache (a cached program holds the models and policy it was built
        with); this pipeline is left as it was."""
        unknown = sorted(name for name in attrs if not hasattr(self, name))
        if unknown:
            raise AttributeError(f"{type(self).__name__} has no attribute(s) {unknown}")
        new = copy.copy(self)
        for name, value in attrs.items():
            setattr(new, name, value)
        new._programs = {}
        return new

    def _program(self, key: tuple, solver: str, record: bool, deterministic_policy: bool,
                 learnable: Callable[[bool], Callable],
                 baseline: Optional[Callable[[], Callable]] = None) -> Callable:
        """The cached program of ``key`` for ``solver``: the learnable
        solver's from ``learnable(deterministic_policy)``, any other from
        ``baseline()`` (a function of the program's arguments returning the
        latents), wrapped to return ``(latents, None)``."""
        learned = self.is_learnable(solver)
        deterministic_policy = bool(deterministic_policy) and learned  # no policy: no fork

        def build():
            if learned:
                return learnable(deterministic_policy)
            base = baseline()
            return lambda *args: (base(*args), None)

        return self._cached((*key, solver, record, deterministic_policy), build)

    def _cached(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        """The program of ``key``, built by ``build()`` on first use."""
        fn = self._programs.get(key)
        if fn is None:
            fn = self._programs[key] = build()
        return fn
