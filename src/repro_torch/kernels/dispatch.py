"""Device-decided dispatcher for the kernels.

Port of ``repro/kernels/dispatch.py``. One registry maps each kernel name
to its implementations per tier (``cuda``: the hand-written Hopper kernel;
``torch``: its plain PyTorch version). Unlike the JAX dispatcher there is
no chain to fall down: the device of the call's tensors picks the tier, a
CUDA tensor resolves to ``cuda`` or raises, a CPU tensor to ``torch``. An
explicit tier (per call, or pinned process-wide through
:func:`repro_torch.compat.set_kernel_tier`) must agree with the device.

A ``cuda`` implementation is registered as differentiable when it goes
through a ``torch.autograd.Function`` (``kernels/autograd.py``); any other
refuses a call under grad whose inputs require grad
(``autograd.check_no_grad``), so no kernel output silently ends a graph.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.kernels.autograd import check_no_grad


class KernelDispatcher:
    """Name -> {tier -> impl} registry resolved by device."""

    def __init__(self):
        self._impls: Dict[str, Dict[str, Callable]] = {}
        self._differentiable = set()

    def register(self, name: str, tier: str, fn: Callable,
                 differentiable: bool = False) -> Callable:
        """``differentiable``: a ``cuda`` impl that carries its own
        gradient (the ``torch`` tier's plain ops always do)."""
        if tier not in compat.KERNEL_TIERS:
            raise ValueError(f"unknown tier {tier!r}; "
                             f"expected one of {compat.KERNEL_TIERS}")
        self._impls.setdefault(name, {})[tier] = fn
        if differentiable:
            self._differentiable.add((name, tier))
        return fn

    def kernels(self) -> Tuple[str, ...]:
        return tuple(sorted(self._impls))

    def registered_tiers(self, name: str) -> Tuple[str, ...]:
        return tuple(t for t in compat.KERNEL_TIERS
                     if t in self._impls.get(name, {}))

    def resolve(self, name: str, device: torch.device,
                tier: Optional[str] = None) -> Tuple[str, Callable]:
        """(tier, impl) for ``name`` on ``device``. ``tier`` (or the pinned
        process tier) must match the device's tier, else RuntimeError."""
        try:
            impls = self._impls[name]
        except KeyError:
            raise KeyError(f"no kernel named {name!r}; "
                           f"registered: {self.kernels()}") from None
        want = compat.device_tier(device)
        pinned = tier if tier is not None else compat.explicit_kernel_tier()
        if pinned is not None and pinned != want:
            raise RuntimeError(
                f"kernel {name!r}: tier {pinned!r} requested for a tensor on "
                f"{torch.device(device)}, which takes the {want!r} tier")
        if want not in impls:
            raise KeyError(
                f"kernel {name!r} has no {want!r} implementation; "
                f"registered tiers: {self.registered_tiers(name)}")
        return want, impls[want]

    def call(self, name: str, *args, tier: Optional[str] = None, **kwargs):
        got, fn = self.resolve(name, args[0].device, tier)
        if got == "cuda" and (name, got) not in self._differentiable:
            check_no_grad(name, args, kwargs)
        return fn(*args, **kwargs)


DISPATCHER = KernelDispatcher()


def register(name: str, tier: str, differentiable: bool = False):
    """Decorator: register ``fn`` as the ``tier`` impl of ``name``."""
    def deco(fn: Callable) -> Callable:
        return DISPATCHER.register(name, tier, fn, differentiable)
    return deco
