"""Stage registry for the fused pipeline graph.

A *stage* is one building block of the fused application (FIR,
delineation, packed rFFT band powers, the SVM epilogue) with a declared
operand signature; a *stage graph* (`graph.py:StageGraph`) chains
registered stages into one application. On the card the biosignal graph
runs as one hand-written kernel (`csrc/biosignal_graph.cu`); on the CPU
the graph runs its stage bodies, which are the plain PyTorch version.

A stage declares four things:

* ``kind`` — ``"fir"`` for the mandatory FIRST stage (a causal k-tap
  FIR), ``"map"`` for everything else;
* ``operands`` — the names of the table operands its body reads (FIR
  taps, twiddles, untangle factors, SVM weights). A graph binds each name
  to a concrete tensor once, outside the body;
* ``requires`` / ``produces`` — the per-frame state keys the body
  consumes and defines. The graph builder checks the dataflow and uses it
  for output elision: a stage only runs when a *requested* output
  transitively depends on it (`graph.py:stages_to_run`);
* ``body`` — ``body(state, tables, params) -> dict`` of new state
  entries, plain PyTorch on (rows, ...) tensors.

Error taxonomy (all rooted at `StageGraphError`, a `ValueError`):
`UnknownStageError` (a graph names a stage that was never registered),
`OperandMismatchError` (a stage's operand signature is not satisfied by
the graph's operand list, or the dataflow is unsatisfiable), and
`UnknownGraphError` (`graph.py:get_graph_factory` lookup miss).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["Stage", "StageGraphError", "UnknownStageError",
           "OperandMismatchError", "UnknownGraphError", "register_stage",
           "get_stage", "registered_stages"]


class StageGraphError(ValueError):
    """Root of the stage-graph error taxonomy (a `ValueError`: graph
    construction errors are bad-argument errors to the caller)."""


class UnknownStageError(StageGraphError):
    """A graph referenced a stage name that is not in the registry."""


class OperandMismatchError(StageGraphError):
    """A stage's declared operand signature (or state dataflow) is not
    satisfied by the graph binding it."""


class UnknownGraphError(StageGraphError):
    """`get_graph_factory` was asked for a graph name never registered."""


@dataclasses.dataclass(frozen=True)
class Stage:
    """One fused-application building block (see the module docstring).
    Frozen and hashable, so a `StageGraph` holding stages can key caches."""
    name: str
    kind: str                       # "fir" | "map"
    operands: tuple                 # table operand names the body reads
    requires: tuple                 # state keys consumed
    produces: tuple                 # state keys defined
    body: Callable                  # body(state, tables, params) -> dict

    def __post_init__(self):
        if self.kind not in ("fir", "map"):
            raise StageGraphError(
                f"stage {self.name!r}: kind must be 'fir' or 'map', "
                f"got {self.kind!r}")
        if self.kind == "fir" and len(self.operands) != 1:
            raise OperandMismatchError(
                f"fir stage {self.name!r} must declare exactly one "
                f"operand (its tap table), got {self.operands}")


_REGISTRY: dict[str, Stage] = {}


def register_stage(name: str, *, kind: str = "map", operands=(),
                   requires=(), produces=()):
    """Decorator registering ``fn`` as the body of stage ``name``.
    Re-registering an existing name raises `StageGraphError` — stages are
    process-wide singletons shared by every graph that names them."""
    def deco(fn):
        if name in _REGISTRY:
            raise StageGraphError(f"stage {name!r} is already registered")
        _REGISTRY[name] = Stage(name=name, kind=kind,
                                operands=tuple(operands),
                                requires=tuple(requires),
                                produces=tuple(produces), body=fn)
        return fn
    return deco


def get_stage(name: str) -> Stage:
    """Registry lookup; raises the typed `UnknownStageError` on a miss."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownStageError(
            f"unknown stage {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered_stages() -> tuple:
    """Registered stage names, sorted."""
    return tuple(sorted(_REGISTRY))
