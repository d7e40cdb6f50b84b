"""Roofline terms for the NVIDIA H100 from a traced step.

Port of ``repro.launch.roofline``.  Three terms, per (arch x shape x
mesh), all in seconds:

    compute    = FLOPs / (chips * peak FLOP/s of the model's dtype)
    memory     = bytes / (chips * HBM bytes/s)
    collective = collective bytes per chip / link bytes/s

with the rates of :class:`repro_torch.dist.meter.H100Model` (NVIDIA's
published H100 SXM numbers; the link term's assumption is stated there).

Where the reference reads XLA's ``cost_analysis`` of a compiled,
SPMD-partitioned module and parses its HLO text for collectives, the port
counts what one rank does while the step runs eagerly on DTensors
(:class:`DeviceCount`, a ``TorchDispatchMode``):

* FLOPs: ``torch.utils.flop_counter``'s formulas for the matmul-class
  ops on each local op's shapes, one FLOP per output element of a
  pointwise op and one per input element of a reduction or scatter-add
  (XLA's ``cost_analysis`` counts elementwise work too).  The mode steps aside for DTensor calls (returns
  ``NotImplemented``), so it sees the local ops DTensor runs on the
  rank's shards and never a DTensor's global shape; the shape inference
  DTensor's sharding propagation runs on FakeTensors is not counted.
* bytes: each local op's input and output tensor bytes, views and
  allocations left out: an eager, unfused count, so above XLA's.
* collectives: every ``_c10d_functional`` / ``c10d`` collective the rank
  issues, at its output bytes, counted once (``wait_tensor`` is not a
  second one), by the reference's kind names.  Each of DTensor's is also
  attributed to the port's code that caused it: explicit when the code
  asked for the layout (a ``redistribute``, its backward, or a layout
  call: ``ShardingCtx.constrain``, ``distribute``), implicit when DTensor
  chose it to run an op; a ``c10d`` call (the program's own psum) is
  explicit.  A collective a receive stands for is counted at the buffer
  it fills.
"""

from __future__ import annotations

import dataclasses
import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.meter import H100Model

H100 = H100Model()

# collective op name -> the reference's HLO kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",  # counted at the received buffer; a send is its twin
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "scatter_": "scatter",
}
# arithmetic ops that are not pointwise: one FLOP per element they read
# (index_add: per source element)
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod", "cumsum",
               "var_mean", "norm", "linalg_vector_norm", "index_add", "scatter_add",
               "_softmax", "_log_softmax"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames of the port that ask for a layout: a collective under them is explicit
_EXPLICIT = {("sharding/specs.py", "constrain"), ("sharding/specs.py", "distribute")}


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """``file:function`` of the innermost frame of the port's own code, or
    ``explicit`` where the collective serves a layout the code asked for:
    a ``redistribute`` call (or its backward) or a layout call."""
    stack = traceback.extract_stack()
    for frame in stack:
        path = frame.filename.replace(os.sep, "/")
        if (path.endswith("distributed/tensor/_api.py") and frame.name == "redistribute") or \
                (path.endswith("distributed/tensor/_redistribute.py") and frame.name == "backward"):
            return "explicit"
    for frame in reversed(stack):
        path = os.path.abspath(frame.filename)
        if path.startswith(_PACKAGE) and not path.endswith("launch/roofline.py"):
            rel = os.path.relpath(path, _PACKAGE).replace(os.sep, "/")
            if (rel, frame.name) in _EXPLICIT:
                return "explicit"
            return f"{rel}:{frame.name}"
    return "outside the port"


class DeviceCount(TorchDispatchMode):
    """What one rank computes, moves and communicates in a traced region:
    ``flops``, ``bytes``, ``collectives`` (kind -> output bytes),
    ``implicit`` (``"file:function op kind"`` -> output bytes of the
    collectives DTensor issued to run that op) and ``ops`` (local ops run)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives: dict[str, int] = {}
        self.implicit: dict[str, int] = {}
        self._dtensor_op = "redistribute"  # the DTensor op a collective serves

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self._dtensor_op = func._opname
            return NotImplemented  # the local ops DTensor runs come back here
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            return out  # sharding propagation's shape inference, global shapes
        outs = _tensors(out)
        name = func._opname
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _KINDS.get(name)
            if kind is not None:
                # a receive's output is the buffer it fills, passed in
                size = sum(_nbytes(t) for t in (ins if name == "recv_" else outs))
                self.collectives[kind] = self.collectives.get(kind, 0) + size
                # DTensor issues functional collectives; a c10d call is the
                # program's own (a psum), never an implicit redistribute
                site = _site() if func.namespace == "_c10d_functional" else "explicit"
                if site != "explicit":
                    key = f"{site} {self._dtensor_op} {kind}"
                    self.implicit[key] = self.implicit.get(key, 0) + size
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif name in _REDUCTIONS and ins:
            self.flops += ins[0].numel() if name != "index_add" else ins[2].numel()
        if outs and not func.is_view and not name.startswith(("empty", "new_empty")):
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "collectives": dict(self.collectives), "implicit": dict(self.implicit)}


@dataclasses.dataclass
class Roofline:
    flops_total: float
    hbm_bytes_total: float
    collective_bytes_per_chip: float
    chips: int
    dtype: str = "bfloat16"

    @property
    def compute_s(self) -> float:
        return self.flops_total / (self.chips * H100.peak_flops(self.dtype))

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_total / (self.chips * H100.hbm_Bps)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / H100.link_Bps(self.chips)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_total": self.flops_total,
            "hbm_bytes_total": self.hbm_bytes_total,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "chips": self.chips,
            "dtype": self.dtype,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def from_trace(count: DeviceCount, chips: int, dtype: str = "bfloat16") -> Roofline:
    """The roofline terms of a traced step: one rank's counts times
    ``chips`` (every rank of an SPMD step does the same work)."""
    return Roofline(
        flops_total=float(count.flops) * chips,
        hbm_bytes_total=float(count.bytes) * chips,
        collective_bytes_per_chip=float(sum(count.collectives.values())),
        chips=chips,
        dtype=dtype,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D per generated/scored token for
    inference (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
