"""What a step costs the card, counted per rank: operations, bytes and
collectives (the port's counterpart of what ``repro.launch.dryrun`` read
from XLA's ``cost_analysis`` and the optimized HLO's collectives).

The port runs eagerly, so the count is of the work the card really does:
every aten op the step dispatches, and every hand-written kernel, one
call with known inputs and outputs, by its formula below.  The same count
runs on fake tensors (``FakeTensorMode``: shapes and dtypes, no storage),
which is the dry-run, and on real tensors on the card, which checks it.

``StepCounters`` opens the three counters in one ``with``:

  * ``flops``: a ``torch.utils.flop_counter.FlopCounterMode`` whose
    formulas count the aten ops (matmuls, convolutions, SDPA), extended
    with the kernels' operations (``add_kernel``);
  * ``bytes``: the input and output bytes of every aten op that is not a
    view, an allocation or a collective, plus each kernel's bytes;
  * ``collectives``: every functional or c10d collective under
    ``repro``'s kind names (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute`` for send
    and recv), with count and output bytes per rank, by mesh axis.

Counts are per rank, on local shapes.  An op on DTensors is left to
DTensor (the counting mode returns ``NotImplemented``), so the counters
see the local ops it runs and the collectives it launches, never the
global op; DTensor's sharding propagation, which runs the op once at the
global shape on fake tensors to learn the output's shape, is hidden from
every dispatch mode while the counters are open.

The kernels' formulas (``*_work``) and the hooks by which a wrapper
records a call live in the kernels' layer, ``repro_torch.kernels.work``;
an open ``StepCounters`` receives every call there.
"""
from __future__ import annotations

import collections
import contextlib
import copy
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import work


def trace_device() -> str:
    """The device the dry-run makes its fake tensors on: cuda where this
    build of torch has CUDA, else cpu.  A fake CUDA tensor needs the
    build's CUDA device guard once autograd records it (a CPU-only build
    aborts the process there); on a fake tensor of either device the
    attention entry points take the kernels' lowering, as on the card."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------

class FlopCounter(FlopCounterMode):
    """``FlopCounterMode``'s formulas and tables, fed by ``StepCounters``'
    dispatch mode (it is not entered itself) and by the kernels."""

    def __init__(self) -> None:
        super().__init__(display=False)
        self.kernel_flops: collections.Counter = collections.Counter()

    def count(self, func, out, args, kwargs) -> None:
        fn = self.flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flop_counts["Global"][func._overloadpacket] += fn(
                *args, **kwargs, out_val=out)

    def add_kernel(self, name: str, flops: float) -> None:
        self.kernel_flops[name] += flops

    def total(self) -> float:
        return float(sum(self.flop_counts["Global"].values())
                     + sum(self.kernel_flops.values()))


# allocations write nothing; collectives are counted on their own
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


class ByteCounter:
    """Input plus output bytes of every counted aten op, by op, and the
    kernels' bytes, by kernel."""

    def __init__(self) -> None:
        self.by_op: collections.Counter = collections.Counter()
        self.kernel_bytes: collections.Counter = collections.Counter()

    def count(self, func, out, args, kwargs) -> None:
        if func.namespace != "aten" or func.is_view \
                or func._overloadpacket.__name__ in _ALLOC:
            return
        self.by_op[str(func._overloadpacket)] += (_nbytes((args, kwargs))
                                                  + _nbytes(out))

    def add_kernel(self, name: str, nbytes: int) -> None:
        self.kernel_bytes[name] += nbytes

    def total(self) -> int:
        return int(sum(self.by_op.values()) + sum(self.kernel_bytes.values()))


_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("send", "collective-permute"), ("recv", "collective-permute"),
          ("broadcast", "broadcast"))


def _kind(func) -> str | None:
    if func.namespace not in ("_c10d_functional", "_c10d_functional_autograd",
                              "c10d", "c10d_functional"):
        return None
    name = func._overloadpacket.__name__
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


class CollectiveCounter:
    """Collectives by ``repro``'s kind names: {kind: {"count", "bytes",
    "axes": {axis: {"count", "bytes"}}}}, bytes the output's per rank
    (``repro``'s convention for the partitioned HLO).  The axis is the
    mesh dim whose group the collective runs over (``world`` for the
    default group, the group's name for any other)."""

    def __init__(self, mesh: Any = None) -> None:
        self.axis_of: dict[str, str] = {}
        if mesh is not None:
            for d, name in enumerate(mesh.mesh_dim_names):
                self.axis_of[mesh.get_group(d).group_name] = name
        self.stats: dict[str, dict] = {}

    def _axis(self, args, kwargs) -> str:
        """The mesh axis of the group the collective names: a functional
        collective's group name is its last string argument, a c10d op's
        group its ProcessGroup argument."""
        import torch.distributed as dist

        flat = tree_flatten((args, kwargs))[0]
        names = [a for a in flat if isinstance(a, str)]
        names += [a.group_name for a in flat
                  if isinstance(getattr(a, "group_name", None), str)]
        if not names:
            return "world"
        name = names[-1]
        if name in self.axis_of:
            return self.axis_of[name]
        if dist.is_initialized() and name == dist.group.WORLD.group_name:
            return "world"
        return name

    def count(self, kind: str, func, out, args, kwargs) -> None:
        nbytes = _nbytes(out if out is not None else args[0])
        axis = self._axis(args, kwargs)
        d = self.stats.setdefault(kind, {"count": 0, "bytes": 0,
                                         "axes": {}})
        d["count"] += 1
        d["bytes"] += nbytes
        a = d["axes"].setdefault(axis, {"count": 0, "bytes": 0})
        a["count"] += 1
        a["bytes"] += nbytes


class _CountMode(TorchDispatchMode):
    def __init__(self, owner: "StepCounters") -> None:
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # count the local ops DTensor runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        o = self.owner
        kind = _kind(func)
        if kind is not None:
            o.collectives.count(kind, func, out, args, kwargs)
        elif func.namespace == "aten":
            o.flops.count(func, out, args, kwargs)
            o.bytes.count(func, out, args, kwargs)
        return out


@contextlib.contextmanager
def _propagation_hidden(memo: dict):
    """Run two pieces of DTensor's machinery with every dispatch mode off:
    its sharding propagation, which executes each new op once at the
    global shape on fake tensors (work no rank does), and a strided
    shard's local size, which it computes with tensor ops and reads back
    (a fake tensor has nothing to read; the result is kept, since DTensor
    asks again for the same arguments thousands of times a step, so
    ``memo`` keeps a strided shard's (local size, offset) by its
    arguments, a pure function, for as long as one counter is open)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError("this torch's DTensor has no tensor-meta "
                           "propagation to hide from the counters")
    hooks = [(ShardingPropagator, name)]
    if "local_shard_size_and_offset" in _StridedShard.__dict__:
        hooks.append((_StridedShard, "local_shard_size_and_offset"))
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr in hooks]

    def hidden(orig, memo: bool):
        fn = orig.__func__ if isinstance(orig, staticmethod) else orig

        def run(*args, **kwargs):
            key = (args, tuple(sorted(kwargs.items()))) if memo else None
            if key is not None:
                try:
                    return copy.deepcopy(memo[key])
                except (KeyError, TypeError):
                    pass
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            if key is not None:
                try:
                    memo[key] = copy.deepcopy(out)
                except TypeError:
                    pass
            return out
        return staticmethod(run) if isinstance(orig, staticmethod) else run

    for cls, attr, orig in saved:
        setattr(cls, attr, hidden(orig, cls is _StridedShard))
    try:
        yield
    finally:
        for cls, attr, orig in saved:
            setattr(cls, attr, orig)


class StepCounters:
    """The three counters in one ``with`` (see the module docstring);
    ``mesh`` names the axes of the collectives.  ``summary()`` gives the
    totals as a record's ``cost`` and ``collectives``."""

    def __init__(self, mesh: Any = None) -> None:
        self.flops = FlopCounter()
        self.bytes = ByteCounter()
        self.collectives = CollectiveCounter(mesh)
        self.kernel_calls: collections.Counter = collections.Counter()
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "StepCounters":
        self._stack.enter_context(_propagation_hidden({}))
        self._stack.enter_context(_CountMode(self))
        self._stack.enter_context(work.counting(self))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()

    def add_kernel(self, name: str, flops: float, nbytes: int) -> None:
        """One kernel call's work (``kernels.work.record_call``)."""
        self.flops.add_kernel(name, flops)
        self.bytes.add_kernel(name, nbytes)
        self.kernel_calls[name] += 1

    def summary(self) -> dict:
        return {
            "flops_per_device": self.flops.total(),
            "bytes_per_device": self.bytes.total(),
            "kernel_flops": dict(self.flops.kernel_flops),
            "kernel_bytes": dict(self.bytes.kernel_bytes),
            "kernel_calls": dict(self.kernel_calls),
        }

