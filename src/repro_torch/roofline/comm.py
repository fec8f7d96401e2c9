"""The collectives a step issues, and their wire bytes per device (the
port's counterpart of ``repro/roofline/hlo.py``, which parses XLA's HLO
text; torch has none), with the step's memory traffic and peak.

:class:`StepRecorder` is a ``TorchDispatchMode``. Over the functional
collectives (``_c10d_functional``) that DTensor's redistributions and
``torch.distributed._functional_collectives`` issue, it records each one's
kind, group size ``n`` and result bytes. The wire bytes per device use
``hlo.py``'s ring factors:

    all_gather       result_bytes * (n-1)/n
    reduce_scatter   result_bytes * (n-1)      (the input is n results)
    all_reduce       2 * bytes * (n-1)/n       (RS + AG)
    all_to_all       bytes * (n-1)/n
    permute          bytes                     (point-to-point)

The collectives are read where DTensor issues them on one rank's local
shards. The recorder also sums ``bytes_accessed``: the bytes every op
that is not a view or a collective reads and writes on one rank (a
DTensor's local shard, a plain tensor whole), each op as the step calls
it. Each op is counted as if unfused, so what a fused
kernel keeps on chip counts too: the memory term built on it is an upper
estimate, where the reference reads XLA's post-fusion ``bytes accessed``.

And ``peak_bytes``: the most bytes on one rank that the tensors created
during the block held at once (each op's new outputs, freed when the last
reference goes; views and in-place results add nothing). torch's
``MemTracker`` is not used: it sizes a DTensor that an in-place op writes
at its global size (a decode step's cache update, one layer of
qwen2-1.5b at decode_32k on the 256-rank mesh: 2.1 GB against a 16.7 MB
shard, torch 2.13).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

class Collective(NamedTuple):
    kind: str
    n: int            # ranks in the group
    nbytes: int       # bytes of the result on one rank


# functional op name -> (kind, index of the group size argument or None)
_OPS = {
    "all_reduce": ("all_reduce", None),
    "all_reduce_": ("all_reduce", None),
    "all_gather_into_tensor": ("all_gather", 1),
    "reduce_scatter_tensor": ("reduce_scatter", 2),
    "all_to_all_single": ("all_to_all", None),
}

# ops that move no data
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "detach", "alias",
               "lift_fresh", "_local_scalar_dense")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(args, size_arg) -> int:
    if size_arg is not None:
        return int(args[size_arg])
    from repro_torch import compat
    return compat.group_size(args[-1])


def _local(t):
    """A DTensor's local shard, or the tensor itself."""
    return getattr(t, "_local_tensor", t)


def _local_bytes(tree) -> int:
    """Bytes on one rank of the tensors in ``tree`` (args or outputs)."""
    total = 0
    for t in (tree if isinstance(tree, (list, tuple)) else (tree,)):
        if isinstance(t, (list, tuple)):
            total += _local_bytes(t)
        elif isinstance(t, torch.Tensor):
            total += _nbytes(_local(t))
    return total


class _Collectives(TorchDispatchMode):
    """The functional collectives, as one rank issues them: a DTensor op is
    handed back to DTensor (``NotImplemented``, as ``CommDebugMode`` does),
    whose local ops and collectives then come here."""

    def __init__(self, records: List[Collective]):
        super().__init__()
        self.records = records

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            entry = _OPS.get(func._opname)
            if entry is not None:
                kind, size_arg = entry
                self.records.append(Collective(
                    kind, _group_size(args, size_arg), _nbytes(out)))
        return out


class _Traffic(TorchDispatchMode):
    """Bytes read and written, and live bytes, of each op as the step
    calls it (a DTensor op sized by its local shards)."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                or func.is_view or func._opname in _NO_TRAFFIC:
            return out
        self.bytes_accessed += _local_bytes(args) + _local_bytes(out)
        if not func._schema.is_mutable:
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, torch.Tensor):
                    n = _nbytes(_local(t))
                    self.live_bytes += n
                    weakref.finalize(t, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


class StepRecorder:
    """``with StepRecorder() as rec: ...``; then ``rec.records``,
    ``rec.bytes_accessed`` and ``rec.peak_bytes``. Enter a
    ``FlopCounterMode`` after it, so that the counter sees each DTensor
    op whole."""

    def __init__(self):
        self.records: List[Collective] = []
        self._modes = (_Collectives(self.records), _Traffic())

    @property
    def bytes_accessed(self) -> int:
        return self._modes[1].bytes_accessed

    @property
    def peak_bytes(self) -> int:
        return self._modes[1].peak_bytes

    def __enter__(self):
        for mode in self._modes:
            mode.__enter__()
        return self

    def __exit__(self, *exc):
        for mode in reversed(self._modes):
            mode.__exit__(*exc)
        return False


def wire_bytes(c: Collective) -> float:
    """Bytes one device sends for ``c`` under a ring algorithm."""
    frac = (c.n - 1) / max(c.n, 1)
    if c.kind == "all_reduce":
        return 2 * c.nbytes * frac
    if c.kind == "permute":
        return float(c.nbytes)
    if c.kind == "reduce_scatter":
        return float(c.nbytes * (c.n - 1))
    return c.nbytes * frac                      # all_gather, all_to_all


def collective_bytes(records) -> Tuple[float, Dict[str, float]]:
    """(total wire bytes per device, per-kind breakdown)."""
    per_kind: Dict[str, float] = defaultdict(float)
    for c in records:
        per_kind[c.kind] += wire_bytes(c)
    return float(sum(per_kind.values())), dict(per_kind)


def collective_count(records) -> Dict[str, int]:
    out: Dict[str, int] = defaultdict(int)
    for c in records:
        out[c.kind] += 1
    return dict(out)
