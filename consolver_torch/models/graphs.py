"""CUDA graphs of a model's forward, captured once per input signature and
replayed inside the model's own call.

:class:`ForwardGraphs` wraps a forward body.  While ``enabled``, a call
whose inputs are all contiguous CUDA tensors, made with autograd off, runs
from a graph of its signature (the inputs' shapes, dtypes and device, the
call's flags, inference mode and the TF32 settings, which pick kernels):

- the first call of a signature runs the body eagerly on a side stream (the
  warm-up PyTorch's protocol asks for; its output is that call's answer),
  then captures the body on static input buffers into a new graph, in the
  one memory pool the wrapper's graphs share, with
  ``capture_error_mode="thread_local"`` (other threads may copy on their own
  streams meanwhile).  A capture that raises leaves the signature eager;
- every later call copies its inputs into the static buffers, replays the
  graph on the caller's stream and returns a copy of the static output,
  never the buffer, which the next replay overwrites.

Calls and captures hold one lock, and the graphs share their pool, so the
callers of one model replay on one stream.  Graphs read the parameters'
storage as it was at capture: ``load_state_dict`` copies in place and is
seen by the next replay, while a model that replaces its parameters
(``.to()``, ``.half()``) drops its graphs (:meth:`clear`).

Kernel launch counters (kernel #1's ``flash_attention.launches``,
``launches_by_route`` and ``launches_by_design``, the int8 GEMM's
``int_mm.launches``) stay true: the capture's wrapper calls launch nothing
and are taken back out, and each replay adds the launches its graph holds.

Spans (:mod:`consolver_torch.utils.profiling`), named after the model's
call span (``model.unet``): ``<name>.capture`` per captured signature (its
time is the capture's cost), ``<name>.replay`` per replayed call and
``<name>.eager_fallback`` per signature whose capture raised.
"""

from __future__ import annotations

import threading
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from consolver_torch.kernels import flash_attention as _fa
from consolver_torch.kernels import quant as _quant
from consolver_torch.utils import profiling


def launch_counts() -> Dict[str, int]:
    """The kernel launch counters a graph must keep true, by name."""
    fa = _fa.flash_attention
    counts = {"flash_attention": fa.launches, "int_mm": _quant.int_mm.launches}
    counts.update({f"flash_attention.{route}": n for route, n in fa.launches_by_route.items()})
    counts.update({f"flash_attention.design.{design}": n
                   for design, n in fa.launches_by_design.items()})
    return counts


def set_launch_counts(counts: Dict[str, int]) -> None:
    fa = _fa.flash_attention
    fa.launches = counts["flash_attention"]
    _quant.int_mm.launches = counts["int_mm"]
    for route in fa.launches_by_route:
        fa.launches_by_route[route] = counts[f"flash_attention.{route}"]
    for design in fa.launches_by_design:
        fa.launches_by_design[design] = counts[f"flash_attention.design.{design}"]


def _add_launches(launched: Dict[str, int]) -> None:
    counts = launch_counts()
    set_launch_counts({name: n + launched.get(name, 0) for name, n in counts.items()})


class _Graph:
    """One captured signature: the graph, its static inputs and output, and
    the kernel launches it holds."""

    __slots__ = ("graph", "inputs", "output", "launches")

    def __init__(self, graph, inputs: Sequence[torch.Tensor], output: torch.Tensor):
        self.graph, self.inputs, self.output = graph, list(inputs), output
        self.launches: Dict[str, int] = {}

    def replay(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        _add_launches(self.launches)
        return self.output.clone()


class ForwardGraphs:
    """The CUDA graphs of one model's forward (module docstring).  ``name``
    is the model's call span; ``enabled`` is off until its owner (a serving
    engine) turns it on."""

    def __init__(self, name: str):
        self.name = name
        self.enabled = False
        self._lock = threading.Lock()
        # signature -> its graph, or None where the capture raised
        self._graphs: Dict[Tuple, Optional[_Graph]] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def __reduce__(self):
        # a copy of the model (deepcopy, pickle) holds other parameters: it
        # starts with no graphs, disabled
        return ForwardGraphs, (self.name,)

    def clear(self) -> None:
        """Drop every graph (their pool is freed with the last of them)."""
        with self._lock:
            self._graphs = {}
            self._pool = self._stream = None

    @property
    def signatures(self) -> Dict[Tuple, bool]:
        """Signature -> whether it has a graph (False: it fell back to eager)."""
        with self._lock:
            return {key: graph is not None for key, graph in self._graphs.items()}

    def takes(self, inputs: Sequence) -> bool:
        """Whether a call with these inputs runs from a graph: enabled, autograd
        off, every input a contiguous CUDA tensor (a host number or tensor
        would be baked into the graph)."""
        return (self.enabled and not torch.is_grad_enabled()
                and all(torch.is_tensor(x) and x.is_cuda and x.is_contiguous() for x in inputs))

    def __call__(self, body: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                 *flags) -> torch.Tensor:
        """``body(*inputs, *flags)``, from the graph of the call's signature
        (captured now if it is new).  Callers check :meth:`takes` first."""
        key = _signature(inputs, flags)
        with self._lock:
            if key not in self._graphs:
                return self._capture(key, body, inputs, flags)
            graph = self._graphs[key]
            if graph is not None:
                with profiling.span(f"{self.name}.replay"):
                    return graph.replay(inputs)
        return body(*inputs, *flags)

    def _capture(self, key, body, inputs, flags) -> torch.Tensor:
        out = self._warm_up(body, inputs, flags)
        before = launch_counts()
        with profiling.span(f"{self.name}.capture") as sp:
            try:
                graph = self._record(body, inputs, flags)
            except Exception as exc:  # noqa: BLE001 - any capture failure leaves the signature eager
                sp.name = f"{self.name}.eager_fallback"
                graph = None
                warnings.warn(f"{self.name}: the CUDA graph capture of {key[0]} raised {exc!r}; "
                              "that signature stays eager")
            finally:
                captured = launch_counts()
                set_launch_counts(before)
        if graph is not None:
            graph.launches = {n: captured[n] - before[n] for n in before
                              if captured[n] != before[n]}
        self._graphs[key] = graph
        return out

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _warm_up(self, body, inputs, flags) -> torch.Tensor:
        """The eager body on the capture's side stream, so that cuBLAS and
        cuDNN set up for it before the capture; its output is the call's
        answer, and its launches are real."""
        device = inputs[0].device
        stream, current = self._side_stream(device), torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = body(*inputs, *flags)
        current.wait_stream(stream)
        return out

    def _record(self, body, inputs, flags) -> _Graph:
        """Capture the body on static copies of the inputs' shapes."""
        static = [torch.empty_like(x) for x in inputs]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            output = body(*static, *flags)
        return _Graph(graph, static, output)


def _signature(inputs: Sequence[torch.Tensor], flags: tuple) -> Tuple:
    return (tuple((tuple(x.shape), x.dtype, x.device) for x in inputs), flags,
            torch.is_inference_mode_enabled(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
