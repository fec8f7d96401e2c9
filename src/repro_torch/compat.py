"""Kernel tiers, devices and build/launch counters for the PyTorch port.

Port of the tier and device part of ``repro/compat.py`` (lines 341-500).
The JAX package probes a chain of tiers and falls down it; the port does
not. Which implementation runs is decided by the device of the tensors:

    ``cuda``  — the hand-written Hopper kernels (CUDA C++ built with
                ``nvcc``); CUDA tensors only
    ``torch`` — the plain PyTorch versions beside each kernel; CPU
                tensors only

There is no fallback: a CUDA tensor takes its kernel or raises, a CPU
tensor takes the plain version. ``REPRO_TORCH_KERNEL_TIER`` (or
:func:`set_kernel_tier`) pins the tier explicitly; it is honored verbatim
and a call whose device does not match it raises.

The build counter is the torch twin of ``repro.compat.CompileCounter``:
it counts every ``nvcc`` compile (read at the edges of a counted block),
so a serving run can show that it built nothing after warmup. The capture
counter counts CUDA-graph captures the same way (the executor's twin of
the reference's AOT compiles). The launch counter counts kernel launches
per kernel name, so a run can show that its main path went through the
kernels; launches noted while a graph is captured go to a
:class:`LaunchRecorder` instead, and each replay of the graph adds them.

:func:`child_env` is the environment of a replica child process.
"""
from __future__ import annotations

import os
import threading
from collections import Counter
from typing import Dict, Optional

import torch

KERNEL_TIERS = ("cuda", "torch")
_TIER_ENV = "REPRO_TORCH_KERNEL_TIER"
_explicit_tier: Optional[str] = None


# --------------------------------------------------------------------------
# Devices
# --------------------------------------------------------------------------


def default_device() -> torch.device:
    """The device entry points run on unless the caller names one.

    Always ``cuda``: a host without a CUDA device raises instead of
    quietly running on the CPU. Pass ``device="cpu"`` to ask for the
    plain path explicitly (the tests do)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`.
    A CUDA device that is not present raises. ``meta`` (shapes and types
    only, nothing allocated) serves the dry-run's specs."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu "
                         f"or meta")
    return dev


def visible_cards() -> list:
    """The card numbers this process may use: ``CUDA_VISIBLE_DEVICES`` as
    set, else every card torch counts (none without CUDA)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    if env:
        return [c.strip() for c in env.split(",") if c.strip()]
    if not torch.cuda.is_available():
        return []
    return [str(i) for i in range(torch.cuda.device_count())]


# variables a child takes from the parent where the parent has them: the
# CUDA toolkit (``nvcc``), its shared libraries and the temp directory
_CHILD_PASSTHROUGH = ("CUDACXX", "CUDA_HOME", "LD_LIBRARY_PATH", "TMPDIR")


def child_env(rid: int = 0, device: str = "cuda", **extra) -> dict:
    """Minimal env for a replica child process (``serving/ipc.py``): the
    port's counterpart of ``repro.compat.cpu_subprocess_env`` and
    ``host_devices_env``.

    It carries ``PATH`` and ``HOME`` (and ``extra``, e.g. ``PYTHONPATH``),
    plus the toolkit and library variables where the parent has them, so
    the child finds ``nvcc`` and the card. On the card (``device ==
    "cuda"``) ``CUDA_VISIBLE_DEVICES`` pins the child to the parent's
    visible card ``rid mod count``: on one card every child shares card
    0. It never sets ``JAX_PLATFORMS`` (the port has no JAX) and never an
    empty ``CUDA_VISIBLE_DEVICES``."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", os.path.expanduser("~"))}
    for key in _CHILD_PASSTHROUGH:
        if os.environ.get(key):
            env[key] = os.environ[key]
    cards = visible_cards() if torch.device(device).type == "cuda" else []
    if cards:
        env["CUDA_VISIBLE_DEVICES"] = cards[int(rid) % len(cards)]
    env.update(extra)
    return env


# --------------------------------------------------------------------------
# Tiers
# --------------------------------------------------------------------------


def tier_available(tier: str) -> bool:
    """Whether a dispatch tier can execute on this host."""
    if tier == "cuda":
        return torch.cuda.is_available()
    return tier == "torch"


def device_tier(device) -> str:
    """The tier a tensor on ``device`` takes: ``cuda`` on a CUDA device,
    ``torch`` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda"
    if dev.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel tier for device {dev}")


def _env_tier() -> Optional[str]:
    env = os.environ.get(_TIER_ENV, "").strip().lower()
    if not env:
        return None
    if env not in KERNEL_TIERS:
        raise ValueError(f"{_TIER_ENV}={env!r}: expected one of {KERNEL_TIERS}")
    if not tier_available(env):
        raise RuntimeError(
            f"{_TIER_ENV}={env!r} requested but that tier is not available "
            f"on this host")
    return env


def explicit_kernel_tier() -> Optional[str]:
    """The tier the operator pinned (``set_kernel_tier`` or the env var),
    or None when the device decides."""
    if _explicit_tier is not None:
        return _explicit_tier
    return _env_tier()


def set_kernel_tier(tier: str) -> str:
    """Pin the process tier (validated). Returns it."""
    global _explicit_tier
    if tier not in KERNEL_TIERS:
        raise ValueError(f"unknown kernel tier {tier!r}; "
                         f"expected one of {KERNEL_TIERS}")
    if not tier_available(tier):
        raise RuntimeError(f"kernel tier {tier!r} unavailable on this host")
    _explicit_tier = tier
    return tier


def reset_kernel_tier() -> None:
    """Drop the pinned tier (the device decides again)."""
    global _explicit_tier
    _explicit_tier = None


# --------------------------------------------------------------------------
# Build and launch counters
# --------------------------------------------------------------------------

_counter_lock = threading.Lock()
_build_events = 0
_launches: Counter = Counter()


def note_build(n: int = 1) -> None:
    """Record ``n`` kernel builds (nvcc compiles)."""
    global _build_events
    with _counter_lock:
        _build_events += n


def builds() -> int:
    """Kernel builds (nvcc compiles) made so far in this process."""
    return _build_events


class BuildCounter:
    """``with BuildCounter() as bc: ...; bc.count`` — kernel builds during
    the block. The twin of ``repro.compat.CompileCounter``."""

    def __init__(self):
        self._start = 0
        self.count = 0

    def __enter__(self) -> "BuildCounter":
        self._start = builds()
        return self

    def __exit__(self, *exc) -> None:
        self.count = builds() - self._start


_capture_events = 0
_recording = threading.local()


def note_capture(n: int = 1) -> None:
    """Record ``n`` CUDA-graph captures."""
    global _capture_events
    with _counter_lock:
        _capture_events += n


def captures() -> int:
    """CUDA-graph captures made so far in this process."""
    return _capture_events


class CaptureCounter:
    """``with CaptureCounter() as cc: ...; cc.count`` — CUDA-graph captures
    during the block (the capture twin of :class:`BuildCounter`)."""

    def __init__(self):
        self._start = 0
        self.count = 0

    def __enter__(self) -> "CaptureCounter":
        self._start = captures()
        return self

    def __exit__(self, *exc) -> None:
        self.count = captures() - self._start


class LaunchRecorder:
    """``with LaunchRecorder() as rec: <capture>`` — the launches this
    thread notes inside the block go to ``rec.counts``, not to the
    process counts: a captured kernel is recorded, not launched. Each
    replay of the graph then adds them (:func:`add_launches`)."""

    def __init__(self):
        self.counts: Counter = Counter()

    def __enter__(self) -> "LaunchRecorder":
        if getattr(_recording, "counts", None) is not None:
            raise RuntimeError("LaunchRecorder blocks do not nest")
        _recording.counts = self.counts
        return self

    def __exit__(self, *exc) -> None:
        _recording.counts = None


def note_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (called by each wrapper right
    where it launches, and nowhere else); inside this thread's
    :class:`LaunchRecorder` the launch is recorded there instead."""
    rec = getattr(_recording, "counts", None)
    if rec is not None:
        rec[name] += 1
        return
    with _counter_lock:
        _launches[name] += 1


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches ``counts`` (a replayed graph's, recorded at its
    capture)."""
    with _counter_lock:
        _launches.update(counts)


def launch_counts() -> Dict[str, int]:
    with _counter_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counter_lock:
        _launches.clear()


# --------------------------------------------------------------------------
# Distribution: the torch APIs the port's distribution and dry-run use,
# pinned in one place. Two of them are private (the fake process group and
# the resolution of a group's name); ``chip_smoke.py`` phase 15 runs the
# dry-run on the card machine's torch to show they hold there too. Each
# import happens at the call, so importing this module touches no process
# group.
# --------------------------------------------------------------------------


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """A process group of ``world_size`` ranks that moves no bytes
    (``torch.testing._internal.distributed.fake_pg``, backend ``fake``):
    collectives return at once, so a step can be traced on one host as
    one rank of a production mesh."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def fake_tensor_mode():
    """``FakeTensorMode`` taking real inputs too: tensors made inside it
    have shapes, types and devices, and no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def implicit_replication():
    """DTensor's context in which a plain tensor meeting a DTensor counts
    as replicated: the constants a step makes inside itself (``arange``
    masks, default positions), as XLA treats an iota under GSPMD."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def group_size(group_name: str) -> int:
    """Ranks of the process group a functional collective names."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()
