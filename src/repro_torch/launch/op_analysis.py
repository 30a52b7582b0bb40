"""What an eager step costs: its operations counted as they are dispatched,
the collective traffic of a layout, and the roofline terms (port of
``repro.launch.hlo_analysis``; ``launch.FROM_REFERENCE`` maps the name).

The reference reads FLOPs and bytes from XLA's cost analysis of a
compiled program and parses the collectives out of its HLO text.  The
port compiles nothing: ``OpCounter`` is a ``TorchDispatchMode`` that sees
every aten operation the step dispatches (the backward and the
recomputation of a checkpointed layer included, which run below
autograd) and counts

  * FLOPs of the matrix products, by ``torch.utils.flop_counter``'s
    registered formulas (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the
    convolutions and fused attentions); elementwise work is not counted;
  * bytes: each distinct input read once and each output written once,
    per operation -- what the eager program moves, nothing fused.  A
    gather (``index``, ``index_select``, ``gather``, ``embedding``) reads
    of its table as many bytes as it returns, and an in-place scatter
    (``index_put_``, ``index_add_``, ``scatter_add_``, ...) reads and
    writes of its target as many bytes as its source holds;
  * live bytes: every storage an operation creates is counted until it
    is freed (a finalizer on the storage), and the largest sum is kept.

Views move nothing and are not counted, nor are allocations that write
nothing (``empty``).  The counts depend on shapes, dtypes and the
operations dispatched, never on values, so a step counted on ``meta``
tensors counts the same as on the CPU or the card.

On ``meta`` most elementwise operations run a Python reference to find
their output's shape, dtype and strides (about 130 µs each), and a
chunked attention repeats the same few operations on the same shapes
thousands of times a layer.  So the counter remembers, per operation
and argument metadata, the layout of outputs that are new storages, and
makes them again with ``torch.empty_strided``: the same tensors, metadata
being all a meta tensor has.

``collective_stats`` prices collective records ``(kind, result_bytes,
group_size)`` with the reference's ring formulas, where
``parse_collectives`` finds them in HLO.  ``roofline_terms`` is the
reference's.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict     # per op kind, per-device result bytes
    wire_bytes: int        # modeled per-device wire traffic (ring algs)

    def as_dict(self):
        return {
            "counts": self.counts,
            "result_bytes": self.result_bytes,
            "wire_bytes": self.wire_bytes,
        }


def collective_stats(records, *, group_size: int = 16) -> CollectiveStats:
    """Counts, result bytes and ring wire bytes of ``records``, each
    ``(kind, result_bytes, n)``: ``kind`` one of all-gather, all-reduce,
    reduce-scatter, all-to-all, collective-permute; ``result_bytes`` the
    per-device result; ``n`` the participants (None: ``group_size``)."""
    counts: dict[str, int] = {}
    rbytes: dict[str, int] = {}
    wire = 0.0
    for kind, b, n in records:
        n = group_size if n is None else n
        counts[kind] = counts.get(kind, 0) + 1
        rbytes[kind] = rbytes.get(kind, 0) + b
        ring = (n - 1) / max(n, 1)
        if kind == "all-gather":
            wire += b * ring                   # result is the gathered buf
        elif kind == "all-reduce":
            wire += 2 * b * ring               # reduce-scatter + all-gather
        elif kind == "reduce-scatter":
            wire += b * n * ring               # result is the scattered buf
        elif kind == "all-to-all":
            wire += b * ring
        elif kind == "collective-permute":
            wire += b
        else:
            raise ValueError(f"unknown collective {kind!r}")
    return CollectiveStats(counts, rbytes, int(wire))


def roofline_terms(
    *,
    flops: float,
    hbm_bytes: float,
    wire_bytes: float,
    n_chips: int,
    hw: dict,
) -> dict:
    """Three roofline terms, in seconds (whole step, already per-device
    because partitioned-HLO costs are per-device)."""
    t_compute = flops / hw["peak_flops_bf16"]
    t_memory = hbm_bytes / hw["hbm_bw"]
    t_collective = wire_bytes / hw["ici_bw"]
    dominant = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_collective), key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_step_s": max(t_compute, t_memory, t_collective),
    }


# Allocations that write nothing, and factories that read only the shape
# of their tensor argument.
_ALLOCATIONS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
                aten.new_empty_strided}
_SHAPE_ONLY = {aten.zeros_like, aten.ones_like, aten.full_like, aten.new_zeros,
               aten.new_ones, aten.new_full}
# Gathers: their first operand is read only where the output comes from.
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# In-place scatters: their target is read and written only where the
# source lands; the source is their last tensor operand.
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.index_add_,
             aten.scatter_, aten.scatter_add_, aten.scatter_reduce_,
             aten.index_copy_}
# In-place operations that overwrite their target without reading it.
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}


def tensors_of(tree, out: list | None = None) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensors_of(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors_of(x, out)
    return out


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (a broadcast
    dimension, of stride 0, once)."""
    if t.numel() == 0:
        return 0
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _key(t: torch.Tensor) -> tuple:
    return (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape),
            t.stride(), t.dtype)


def _signature(x):
    """A hashable description of an operation's argument: a tensor by its
    metadata, a scalar with its type (``1`` and ``1.0`` promote apart)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.storage_offset(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_signature(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _signature(v)) for k, v in x.items()))
    return (type(x), x)


def _fresh_layout(out, outputs, in_storages):
    """``[(shape, stride, dtype)]`` of an operation's outputs on ``meta``
    when each is a new storage of its own that ``torch.empty_strided``
    would make alike, else None."""
    if not isinstance(out, (torch.Tensor, tuple)) or not outputs or (
            isinstance(out, tuple) and len(outputs) != len(out)):
        return None
    storages = set()
    for t in outputs:
        s = t.untyped_storage()
        span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
        if (not t.is_meta or s._cdata in in_storages or s._cdata in storages
                or t.storage_offset() or t.numel() == 0
                or s.nbytes() != span * t.element_size()):
            return None
        storages.add(s._cdata)
    return [(tuple(t.shape), t.stride(), t.dtype) for t in outputs]


class OpCounter(TorchDispatchMode):
    """Counts the aten operations dispatched inside it: ``ops``, ``flops``
    (matrix products; ``flops_by_op`` by operation), ``bytes`` (each
    operation's distinct inputs read once and outputs written once),
    ``live`` (bytes of the storages the counted operations created that
    are still alive) and ``peak`` (the largest ``live``).  Storages that
    existed before (the step's arguments) are not in ``live``.
    ``live_only`` skips FLOPs and bytes and keeps the memory count."""

    def __init__(self, *, live_only: bool = False):
        super().__init__()
        self.live_only = live_only
        self.ops = 0
        self.flops = 0
        self.bytes = 0
        self.flops_by_op: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._finalizers: dict[int, weakref.finalize] = {}
        self._layouts: dict = {}       # meta outputs by operation and arguments

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self._finalizers.pop(key, None)

    def __exit__(self, *exc):
        # Storages that outlive the mode are no longer counted.
        for fin in self._finalizers.values():
            fin.detach()
        self._finalizers.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if func.is_view or packet in _ALLOCATIONS:
            return func(*args, **kwargs)
        inputs = tensors_of((args, kwargs))
        in_storages = {t.untyped_storage()._cdata for t in inputs}
        signature = None
        if all(t.is_meta for t in inputs):
            signature = (func, _signature(args), _signature(kwargs))
            try:
                hash(signature)
            except TypeError:           # an unhashable argument
                signature = None
        entry = self._layouts.get(signature) if signature is not None else None
        if entry is not None:
            layout, as_tuple = entry
            remade = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                      for shape, stride, dtype in layout]
            out = tuple(remade) if as_tuple else remade[0]
        else:
            out = func(*args, **kwargs)
        outputs = tensors_of(out)
        if signature is not None and entry is None and not func._schema.is_mutable:
            layout = _fresh_layout(out, outputs, in_storages)
            if layout is not None:
                self._layouts[signature] = (layout, isinstance(out, tuple))
        made = False
        for t in outputs:
            s = t.untyped_storage()
            k = s._cdata
            if k not in in_storages and k not in self._finalizers:
                made = True
                nbytes = s.nbytes()
                self.live += nbytes
                self._finalizers[k] = weakref.finalize(s, self._free, k, nbytes)
        self.peak = max(self.peak, self.live)
        mutates = func._schema.is_mutable
        if not made and not mutates:
            return out          # an alias of an input: nothing moved
        self.ops += 1
        if self.live_only:
            return out
        fl = flop_registry.get(packet)
        if fl is not None:
            n = int(fl(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(packet)] += n
        self.bytes += self._moved(packet, inputs, outputs, in_storages, mutates)
        return out

    @staticmethod
    def _moved(packet, inputs, outputs, in_storages, mutates) -> int:
        reads, writes = {}, {}
        if packet in _SCATTERS:
            src = inputs[-1]
            target = inputs[0]
            reads.update((_key(t), tensor_bytes(t)) for t in inputs[1:])
            writes[_key(target)] = reads[_key(target)] = min(
                tensor_bytes(src), tensor_bytes(target))
            return sum(reads.values()) + sum(writes.values())
        if packet in _SHAPE_ONLY:
            inputs = []
        elif packet in _OVERWRITES:
            inputs = inputs[1:]
        elif packet in _GATHERS and outputs:
            table = inputs[0]
            reads[_key(table)] = min(tensor_bytes(table), tensor_bytes(outputs[0]))
            inputs = inputs[1:]
        for t in inputs:
            reads.setdefault(_key(t), tensor_bytes(t))
        for t in outputs:
            if mutates or t.untyped_storage()._cdata not in in_storages:
                writes[_key(t)] = tensor_bytes(t)
        return sum(reads.values()) + sum(writes.values())
