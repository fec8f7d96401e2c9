"""IPC front door for the multi-host serving plane (ROADMAP
"multi-process, multi-host serving plane").

The inproc ``ClusterRouter`` hosts every replica group in one Python
process; this module splits the transport so each replica group runs in
its own OS process (``serving/replica_proc.py`` is the child
entrypoint) — on this host over an inherited socketpair, or on ANY host
over TCP — behind a length-prefixed JSON-over-socket protocol:

  * **frames** — ``config`` / ``hello`` / ``submit`` / ``completion`` /
    ``kill`` / ``drain`` / ``drained`` / ``stats`` / ``heartbeat``
    (plus the TCP-only ``challenge`` / ``auth`` / ``reject`` handshake
    frames), each a JSON object with a ``t`` kind and a per-direction
    monotonic ``seq`` (gap or replay -> ``OutOfOrderFrame``); the wire
    format is a 4-byte big-endian length prefix + UTF-8 JSON body, with
    a hard frame-size cap (``OversizedFrame``), EOF-mid-frame detection
    (``TruncatedFrame``) and body validation (``MalformedFrame``);
  * **transport** — ``ClusterRouter(transport="proc")`` spawns local
    children over socketpairs (trusted: the fd is inherited, no
    handshake); ``listen="HOST:PORT"`` additionally opens a TCP
    listener, spawns local children through it, and lets REMOTE
    children (``replica_proc --connect HOST:PORT --token ...``) be
    *adopted* into the cluster (``adopt_replica``) after an
    HMAC-SHA256 challenge/response handshake: the coordinator sends a
    nonce + protocol version, the child answers with
    ``HMAC(token, nonce:version)``, and a bad/missing token or a
    version mismatch is rejected (``reject`` frame, counted in
    ``handshake_rejects``) before any serving frame flows;
  * **dead-peer detection** — children heartbeat on an interval; the
    coordinator's per-replica watchdog (plus EOF/ConnectionError on
    either stream) feeds peer death into the *existing*
    drain-and-re-route path: ``ClusterCoordinator.redistribute`` is
    still THE surrender path (the coordinator rule), the proc transport
    just re-serializes the orphans to the survivors;
  * **lifecycle** — the coordinator process stays the sole owner of
    admission, placement, and lifecycle. The live ``ClusterAutoscaler``
    (serving/autoscaler.py) rides the proc transport exactly as it
    rides inproc: spawn = fork/connect a child priced at the usual cold
    start (routable only after both the handshake AND the cold start
    complete), decommission = a ``drain`` frame through the
    coordinator's surrender path — transports never spawn/kill replicas
    behind the coordinator's back (the lifecycle rule). A ``ReplicaProxy``
    stands in for the remote engine on the coordinator's placement
    surface; the child's ``Router``/engine owns all scheduling *within*
    the replica, exactly as inproc;
  * **execution** — children serve echo/spin workers by default;
    ``execute="real"`` makes each child build a ``SubnetExecutor``
    (serving/executor.py) from the wire spec's arch name, device, size,
    units and slice mode, so completion frames carry real subnet logits
    and measured latencies instead of echoes.

Clock skew never crosses the boundary: a ``submit`` frame carries the
query's *remaining* SLO, the child recomputes arrival/deadline on its
own wall clock, and the coordinator stamps the master query's finish at
completion-frame receipt (end-to-end latency, IPC included).

Parity bar (tests/test_ipc.py, benchmarks/bench_multiproc.py): a proc
cluster — socketpair or TCP — on a deterministic paced trace reproduces
the inproc ``ClusterRouter``'s completion records — same qids
served/dropped, same served accuracies, same replica assignments —
modulo wall-clock latencies.

Known limits (also in README "Multi-host serving"): payloads must be
JSON-serializable; policies must be registry-constructible by name
(``ALL_POLICIES[name]()``); a completion racing a replica kill or a
graceful decommission may be re-served by a survivor (at-least-once on
death/decommission, exactly-once otherwise); ``execute="real"``
requires the coordinator's ``LatencyProfile`` to be built from the SAME
config the children build (``get_config(arch)`` at the spec's size and
units: ``executor.serving_config``) so both sides agree on the Pareto
subnet set.

A copy of ``repro/serving/ipc.py`` with the port's changes: the spec
carries the executor's ``device``, ``size``, ``units`` and
``slice_mode``, fake XLA host devices do not exist (``host_devices``
must be 0), and children run ``repro_torch.serving.replica_proc`` under
``compat.child_env``, pinned to one visible card each. The frame
protocol is unchanged.
"""
from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import secrets
import subprocess
import sys
import time
import traceback
from collections import deque
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.autoscaler import (AutoscaleConfig, ClusterAutoscaler,
                                      coordinator_forecast)
from repro_torch.serving.cluster import ClusterCoordinator, make_placement
from repro_torch.serving.engine import EngineConfig, WallClock
from repro_torch.serving.forecast import ForecastConfig
from repro_torch.serving.policies import ALL_POLICIES, Policy
from repro_torch.serving.profiler import HardwareProfile, LatencyProfile
from repro_torch.serving.queue import Query
from repro_torch.serving.residency import ActuationModel
from repro_torch.serving.runtime import ClusterRouter

# -- wire format -----------------------------------------------------------

HEADER_BYTES = 4
MAX_FRAME = 8 << 20                     # 8 MiB: no serving frame is close
HEARTBEAT_S = 0.25                      # child -> parent liveness interval
DEAD_AFTER_BEATS = 8                    # missed beats before declared dead
KILL_ALL = -1                           # kill-frame wid sentinel: whole pool
PROTOCOL_VERSION = 1                    # bumped on incompatible frame changes
HANDSHAKE_TIMEOUT_S = 10.0              # challenge -> auth wait on accept
TOKEN_ENV = "REPRO_IPC_TOKEN"           # token env var (kept off argv/ps)


class FrameError(Exception):
    """Base of the protocol error taxonomy."""


class TruncatedFrame(FrameError):
    """Peer closed (or stream ended) in the middle of a frame."""


class MalformedFrame(FrameError):
    """Body is not valid UTF-8 JSON, or not a ``{"t": ..., "seq": ...}``
    object."""


class OversizedFrame(FrameError):
    """Declared length exceeds the frame-size cap."""


class OutOfOrderFrame(FrameError):
    """Sequence number is not the expected next one (drop or replay)."""


def auth_mac(token: str, nonce: str,
             version: int = PROTOCOL_VERSION) -> str:
    """The handshake response: HMAC-SHA256 over the server's nonce AND
    the protocol version, keyed by the shared token — binding the
    version into the MAC means a version-spoofing auth frame fails the
    MAC check even before the explicit version comparison."""
    msg = f"{nonce}:{version}".encode("utf-8")
    return hmac.new(token.encode("utf-8"), msg, hashlib.sha256).hexdigest()


def to_jsonable(x: Any) -> Any:
    """Best-effort conversion of payloads/stats to JSON-safe values
    (numpy scalars/arrays -> python; unknown leaves -> repr)."""
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {str(k): to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return repr(x)


def encode_frame(frame: Dict[str, Any], seq: int,
                 max_frame: int = MAX_FRAME) -> bytes:
    """Stamp ``seq`` and serialize to ``<4-byte len><json body>``."""
    obj = dict(frame)
    obj["seq"] = int(seq)
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > max_frame:
        raise OversizedFrame(
            f"{len(body)}-byte frame exceeds the {max_frame}-byte cap")
    return len(body).to_bytes(HEADER_BYTES, "big") + body


class FrameDecoder:
    """Incremental length-prefixed JSON frame parser.

    Synchronous and transport-free — the same decode path backs the
    asyncio ``FrameStream`` and the protocol unit tests, so the error
    taxonomy is pinned once. ``feed`` returns every complete frame the
    new bytes finish; ``eof`` raises ``TruncatedFrame`` if the stream
    ended mid-frame."""

    def __init__(self, max_frame: int = MAX_FRAME, expect_seq: bool = True):
        self.max_frame = max_frame
        self.expect_seq = expect_seq
        self._buf = bytearray()
        self._need: Optional[int] = None
        self._rx_seq = -1

    def feed(self, data: bytes) -> List[Dict[str, Any]]:
        self._buf.extend(data)
        out: List[Dict[str, Any]] = []
        while True:
            if self._need is None:
                if len(self._buf) < HEADER_BYTES:
                    break
                self._need = int.from_bytes(self._buf[:HEADER_BYTES], "big")
                del self._buf[:HEADER_BYTES]
                if self._need > self.max_frame:
                    raise OversizedFrame(
                        f"peer declared a {self._need}-byte frame "
                        f"(cap {self.max_frame})")
            if len(self._buf) < self._need:
                break
            body = bytes(self._buf[:self._need])
            del self._buf[:self._need]
            self._need = None
            out.append(self._decode(body))
        return out

    def _decode(self, body: bytes) -> Dict[str, Any]:
        try:
            obj = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise MalformedFrame(f"undecodable frame body: {e}") from None
        if not isinstance(obj, dict) or not isinstance(obj.get("t"), str):
            raise MalformedFrame("frame is not an object with a 't' kind")
        if self.expect_seq:
            seq = obj.get("seq")
            if not isinstance(seq, int) or isinstance(seq, bool):
                raise MalformedFrame("frame missing an integer 'seq'")
            if seq != self._rx_seq + 1:
                raise OutOfOrderFrame(
                    f"got seq {seq}, expected {self._rx_seq + 1}")
            self._rx_seq = seq
        return obj

    def eof(self) -> None:
        if self._need is not None or self._buf:
            raise TruncatedFrame(
                f"peer closed mid-frame ({len(self._buf)} bytes buffered, "
                f"{'header' if self._need is None else self._need} pending)")


class FrameStream:
    """Asyncio send/recv of frames over one (reader, writer) pair, with
    per-direction monotonic sequence numbers (assigned on send, verified
    on receive by the shared ``FrameDecoder``)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 max_frame: int = MAX_FRAME):
        self._r = reader
        self._w = writer
        self._tx_seq = 0
        self._tx_lock = asyncio.Lock()
        self._decoder = FrameDecoder(max_frame=max_frame)
        # a deque, not a list: one read() burst can finish hundreds of
        # frames under bursty traffic, and popping a list head is O(n)
        # per frame — O(n^2) per burst
        self._pending: Deque[Dict[str, Any]] = deque()
        self.last_rx = time.monotonic()     # watchdog signal (any bytes)

    async def send(self, frame: Dict[str, Any]) -> None:
        async with self._tx_lock:
            data = encode_frame(frame, self._tx_seq)
            self._tx_seq += 1
            self._w.write(data)
            await self._w.drain()

    async def recv(self) -> Optional[Dict[str, Any]]:
        """Next frame, or None on clean EOF at a frame boundary. Raises
        the ``FrameError`` taxonomy on protocol violations."""
        while not self._pending:
            chunk = await self._r.read(1 << 16)
            if not chunk:
                self._decoder.eof()
                return None
            self.last_rx = time.monotonic()
            self._pending.extend(self._decoder.feed(chunk))
        return self._pending.popleft()

    def close(self) -> None:
        try:
            self._w.close()
        except Exception:
            pass


async def heartbeat_loop(stream: FrameStream,
                         interval: float = HEARTBEAT_S,
                         errors: Optional[Dict[str, int]] = None) -> None:
    """Child-side liveness beacon; cancelled at shutdown.

    A send that hits a dead/backpressured connection must NOT die with
    an unobserved exception — the child would silently stop beating
    while still serving, and the parent's watchdog would declare a live
    replica dead after ``DEAD_AFTER_BEATS``. Connection failures end
    the loop cleanly instead, counted into ``errors`` (surfaced through
    the child's ``stats`` counters as ``heartbeat_send_errors``)."""
    while True:
        await asyncio.sleep(interval)
        try:
            await stream.send({"t": "heartbeat", "now": time.monotonic()})
        except (ConnectionError, OSError, RuntimeError):
            if errors is not None:
                errors["heartbeat_send_errors"] = (
                    errors.get("heartbeat_send_errors", 0) + 1)
            return


# -- replica spec (what crosses the process boundary at spawn) -------------


@dataclass
class _WeightOnlyPoint:
    """Stand-in for a ParetoPoint on the wire: the residency layer's
    ActuationModel reads only ``weight_mb`` (and falls back to a default
    footprint when absent), so the subnet descriptor stays parent-side."""
    weight_mb: float
    acc: float = 0.0
    gflops: float = 0.0
    sub: Any = None


def profile_to_wire(profile: LatencyProfile) -> Dict[str, Any]:
    return {
        "arch": profile.arch,
        "accs": np.asarray(profile.accs, float).tolist(),
        "batches": list(profile.batches),
        "lat": np.asarray(profile.lat, float).tolist(),
        "n_buckets": int(profile.n_buckets),
        "weight_mb": [float(p.weight_mb) for p in profile.points] or None,
        "point_accs": [float(p.acc) for p in profile.points] or None,
    }


def profile_from_wire(spec: Dict[str, Any]) -> LatencyProfile:
    points = []
    if spec.get("weight_mb"):
        accs = spec.get("point_accs") or [0.0] * len(spec["weight_mb"])
        points = [_WeightOnlyPoint(weight_mb=w, acc=a)
                  for w, a in zip(spec["weight_mb"], accs)]
    return LatencyProfile(
        arch=spec["arch"], accs=np.asarray(spec["accs"], float),
        batches=tuple(int(b) for b in spec["batches"]),
        lat=np.asarray(spec["lat"], float), points=points,
        n_buckets=int(spec["n_buckets"]))


def engine_cfg_to_wire(cfg: Optional[EngineConfig]) -> Optional[Dict]:
    if cfg is None:
        return None
    d = asdict(cfg)
    d["hw"] = asdict(cfg.hw)
    d["forecast"] = asdict(cfg.forecast) if cfg.forecast else None
    return d


def engine_cfg_from_wire(d: Optional[Dict]) -> Optional[EngineConfig]:
    if d is None:
        return None
    d = dict(d)
    d["hw"] = HardwareProfile(**d["hw"])
    d["forecast"] = ForecastConfig(**d["forecast"]) if d["forecast"] else None
    return EngineConfig(**d)


@dataclass
class ReplicaSpec:
    """Declarative replica-process recipe: everything the child needs to
    build its ``Router`` — locally spawned or adopted from a remote
    host. Worker ``run`` callables never cross the boundary: the child
    hosts either an echo worker with an optional CPU spin
    (``execute="echo"``, the scale-out benchmark's stand-in) or a real
    ``SubnetExecutor`` built from ``arch``'s config at ``size`` and
    ``units`` on ``device`` (``execute="real"``)."""

    profile: Dict[str, Any]             # profile_to_wire output
    policy: str                         # ALL_POLICIES key
    n_workers: int = 1
    engine_cfg: Optional[Dict] = None   # engine_cfg_to_wire output
    work_ms: float = 0.0                # synthetic per-batch CPU spin
    host_devices: int = 0               # no torch meaning: must be 0
    heartbeat_s: float = HEARTBEAT_S
    execute: str = "echo"               # "echo" | "real" (SubnetExecutor)
    arch: Optional[str] = None          # execute="real": config registry key
    seq_len: int = 16                   # execute="real": tokens per payload
    seed: int = 0                       # execute="real": supernet init seed
    device: str = "cuda"                # execute="real": "cuda" or "cpu"
    size: Optional[str] = None          # "full" | "reduced" (None: by device)
    units: Optional[int] = None         # size "full": repeat units kept
    slice_mode: str = "mask"            # WeightSlice: "mask" | "switch"

    def __post_init__(self):
        if self.host_devices:
            raise ValueError(
                f"host_devices={self.host_devices}: fake XLA host devices "
                f"have no torch meaning; a child takes one visible card")

    def to_wire(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "ReplicaSpec":
        return cls(**d)


# -- coordinator-side replica stand-in -------------------------------------


class _ProxyResidency:
    """The slice of ``ResidencyTracker`` the coordinator reads on a
    remote replica: worker count/ids for the decommission rule
    (``should_decommission``: a replica with no workers can never serve)
    the aggregate switch counters (refreshed from child stats), and the
    cluster's ``ActuationModel`` so the autoscaler can derive replica
    cold start (``AutoscaleConfig.cold_start=None``) exactly as it does
    from an inproc engine's tracker."""

    def __init__(self, n_workers: int, model: ActuationModel):
        self._wids = list(range(n_workers))
        self.model = model
        self.n_switches = 0
        self.n_launches = 0
        self.actuation_seconds = 0.0

    def __len__(self) -> int:
        return len(self._wids)

    def workers(self) -> List[int]:
        return list(self._wids)

    def remove(self, wid: int) -> None:
        if wid in self._wids:
            self._wids.remove(wid)

    def clear(self) -> None:
        self._wids.clear()


class ReplicaProxy:
    """Coordinator-side stand-in for a remote replica's engine.

    Satisfies exactly the surface ``ClusterCoordinator`` (and the
    ``ClusterAutoscaler`` riding it) consumes — ``admit`` / ``fault`` /
    ``surrender_queue`` / ``abandon_pending``, the residency view, and
    the placement introspection methods. All introspection is the
    *parent's* view (master queries pending on the replica), not the
    child's live queue state: round_robin placement is exact; load-aware
    placements and scaling signals see pending counts (documented
    limit). Scheduling still happens only in the child's engine."""

    def __init__(self, replica_id: int, n_workers: int,
                 profile: LatencyProfile, front: "ProcClusterRouter"):
        self.replica_id = replica_id
        self.profile = profile
        self.min_service = float(profile.lat.min())
        self.residency = _ProxyResidency(n_workers, front._actuation_model)
        self.n_joins = 0
        self.pending: Dict[int, Query] = {}     # qid -> outstanding master q
        self.child_stats: Optional[Dict[str, Any]] = None
        self._front = front

    # -- coordinator surface -------------------------------------------

    def admit(self, q: Query) -> None:
        q.replica = self.replica_id
        self.pending[q.qid] = q
        self._front._send_submit(self.replica_id, q)

    def fault(self, wid: int) -> None:
        self.residency.remove(wid)

    def surrender_queue(self) -> List[Query]:
        """Orphans in EDF order (deadline, then FIFO seq/qid) — the
        re-route path re-places them deterministically."""
        out = sorted(self.pending.values(),
                     key=lambda q: (q.deadline, q.seq, q.qid))
        self.pending.clear()
        return out

    def abandon_pending(self) -> List[Query]:
        return []

    # -- placement introspection (parent-side view) --------------------

    def outstanding(self) -> int:
        return len(self.pending)

    def queue_depth(self) -> int:
        return len(self.pending)

    def inflight_depth(self) -> int:
        return 0

    def work_ahead(self, deadline: float) -> int:
        return sum(1 for q in self.pending.values()
                   if q.deadline <= deadline)

    def projected_start(self, deadline: float, now: float) -> float:
        return (self.work_ahead(deadline) * self.min_service
                / max(len(self.residency), 1))

    def resident_subnets(self) -> Dict[int, Optional[int]]:
        return dict.fromkeys(self.residency.workers())

    def likely_subnet(self, slack: float) -> int:
        return int(self.profile.lat[:, 0].argmin())

    def projected_switch_cost(self, pi: int) -> float:
        return 0.0

    def refresh(self, counters: Dict[str, Any]) -> None:
        """Fold a child stats/drained frame's raw counters into the
        coordinator-side aggregates (cluster_summarize reads these)."""
        self.child_stats = counters
        self.n_joins = int(counters.get("n_joins", self.n_joins))
        res = self.residency
        res.n_switches = int(counters.get("n_switches", res.n_switches))
        res.n_launches = int(counters.get("n_launches", res.n_launches))
        res.actuation_seconds = float(
            counters.get("actuation_seconds", res.actuation_seconds))


# -- per-replica channel ----------------------------------------------------


class _Channel:
    """Parent-side bookkeeping for one replica process: subprocess
    handle (None for replicas adopted from a remote host — their
    lifetime belongs to that host), frame stream, sync-callable outbox,
    and its asyncio tasks."""

    def __init__(self, rid: int, proc: Optional[subprocess.Popen] = None):
        self.rid = rid
        self.proc = proc
        self.stream: Optional[FrameStream] = None
        self.outbox: "asyncio.Queue[Optional[dict]]" = asyncio.Queue()
        self.tasks: List[asyncio.Task] = []
        self.hello: Dict[str, Any] = {}
        self.spawn_s: Optional[float] = None    # spawn -> hello (seconds)
        self.drained = asyncio.Event()
        self.stats_ready = asyncio.Event()
        self.protocol_error: Optional[FrameError] = None

    def stop(self, kill: bool = True) -> None:
        for t in self.tasks:
            t.cancel()
        self.tasks.clear()
        if self.stream is not None:
            self.stream.close()
        if kill and self.proc is not None and self.proc.poll() is None:
            self.proc.kill()


def _src_root() -> str:
    # the child must import repro_torch from the same tree as the parent
    import repro_torch
    return str(Path(repro_torch.__file__).resolve().parent.parent)


def spawn_replica_proc(spec: ReplicaSpec, rid: int = 0) -> subprocess.Popen:
    """Start one replica worker process connected by a socketpair.

    The env comes from ``compat.child_env``: a fresh interpreter (never a
    fork, so a parent that has touched CUDA can still spawn) that finds
    ``nvcc`` and the CUDA libraries, pinned to the parent's visible card
    ``rid mod count`` when the spec runs on the card. The parent-side
    socket rides on ``proc._ipc_sock``. The inherited fd is trusted:
    no handshake (only a process the coordinator itself spawned can
    hold the other end)."""
    import socket as socketlib

    from repro_torch.compat import child_env
    parent_sock, child_sock = socketlib.socketpair()
    env = child_env(rid, spec.device, PYTHONPATH=_src_root())
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serving.replica_proc",
         "--fd", str(child_sock.fileno())],
        pass_fds=(child_sock.fileno(),), env=env)
    child_sock.close()
    proc._ipc_sock = parent_sock                # type: ignore[attr-defined]
    return proc


def spawn_replica_proc_tcp(spec: ReplicaSpec, addr: Tuple[str, int],
                           token: str, rid: int = 0) -> subprocess.Popen:
    """Start one replica worker process that dials the coordinator's
    TCP listener and authenticates — the same spawn path a remote host
    runs by hand (``replica_proc --connect HOST:PORT --token ...``).
    The token travels in the child env (``REPRO_IPC_TOKEN``), never on
    argv, so it stays out of process listings."""
    from repro_torch.compat import child_env
    env = child_env(rid, spec.device, PYTHONPATH=_src_root())
    env[TOKEN_ENV] = token
    host, port = addr
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serving.replica_proc",
         "--connect", f"{host}:{port}"], env=env)


# -- the proc-transport cluster front door ---------------------------------


class ProcClusterRouter(ClusterRouter):
    """``ClusterRouter`` with ``transport="proc"``: same public surface
    (``start`` / ``submit`` / ``kill_worker`` / ``kill_replica`` /
    ``drain`` / ``stats`` / ``records``), but every replica group is a
    separate OS process serving frames through ``replica_proc.py`` —
    over inherited socketpairs, or over TCP with ``listen="HOST:PORT"``
    (port 0 picks a free one; resolved address in ``listen_addr``, the
    shared token in ``token``, auto-generated when not given).

    The coordinator (this process) remains the sole owner of admission,
    placement, and lifecycle; the transport is a thin shim — serialize
    the payload, forward the placement decision as a ``submit`` frame,
    stream ``completion`` frames back onto the master queries. Replica
    death (kill, EOF, heartbeat loss) funnels into
    ``ClusterCoordinator.redistribute`` exactly like inproc, and the
    live autoscaler drives spawn/decommission through the same
    coordinator hooks as the inproc plane."""

    def __init__(self, profile: LatencyProfile, policy: Policy,
                 replicas: Sequence, clock=None,
                 engine_cfg: Optional[EngineConfig] = None,
                 placement: str = "round_robin", placement_seed: int = 0,
                 autoscale: Optional[AutoscaleConfig] = None,
                 worker_factory=None, slo: float = 0.036,
                 forecast: Optional[ForecastConfig] = None,
                 transport: str = "proc", work_ms: float = 0.0,
                 host_devices: int = 0, heartbeat_s: float = HEARTBEAT_S,
                 spawn_timeout: float = 60.0,
                 listen: Optional[str] = None, token: Optional[str] = None,
                 execute: str = "echo", arch: Optional[str] = None,
                 seq_len: int = 16, seed: int = 0, device: str = "cuda",
                 size: Optional[str] = None, units: Optional[int] = None,
                 slice_mode: str = "mask"):
        if transport != "proc":
            raise ValueError(f"ProcClusterRouter is the proc transport "
                             f"(got transport={transport!r})")
        if clock is not None and not isinstance(clock, WallClock):
            raise ValueError("the proc transport is wall-clock only "
                             "(virtual parity runs stay inproc)")
        if type(policy) is not ALL_POLICIES.get(policy.name):
            raise ValueError(
                f"policy {type(policy).__name__} is not registry-"
                f"constructible (ALL_POLICIES[{policy.name!r}]()); the "
                f"replica process rebuilds policies by name")
        if execute not in ("echo", "real"):
            raise ValueError(f"execute must be 'echo' or 'real', "
                             f"got {execute!r}")
        if execute == "real" and not arch:
            raise ValueError(
                "execute='real' needs arch=<config registry name>: the "
                "child builds its SubnetExecutor from get_config(arch) at "
                "size/units — build the coordinator's profile from the "
                "same config (executor.serving_config)")
        if token is not None and listen is None:
            raise ValueError("token only applies with listen= "
                             "(socketpair children inherit a trusted fd)")
        self.profile = profile
        self.clock = clock if clock is not None else WallClock()
        counts = [len(g) if isinstance(g, (list, tuple)) else int(g)
                  for g in replicas]
        if not counts or any(c < 1 for c in counts):
            raise ValueError("every replica needs at least one worker")
        self.spec = ReplicaSpec(
            profile=profile_to_wire(profile), policy=policy.name,
            engine_cfg=engine_cfg_to_wire(engine_cfg), work_ms=work_ms,
            host_devices=host_devices, heartbeat_s=heartbeat_s,
            execute=execute, arch=arch, seq_len=seq_len, seed=seed,
            device=device, size=size, units=units, slice_mode=slice_mode)
        self._counts = counts
        self._spawn_timeout = spawn_timeout
        # the TCP front door: parsed listen request, resolved address
        # after _start_listener, the shared HMAC token, and the pairing
        # queues matching authenticated connections to spawn/adopt calls
        self._listen_req: Optional[Tuple[str, int]] = None
        if listen is not None:
            host, _, port = str(listen).rpartition(":")
            if not host or not port.lstrip("-").isdigit():
                raise ValueError(f"listen must be 'HOST:PORT', "
                                 f"got {listen!r}")
            self._listen_req = (host, int(port))
        self.token = token
        if self._listen_req is not None and self.token is None:
            self.token = secrets.token_hex(16)
        self._server: Optional[asyncio.AbstractServer] = None
        self.listen_addr: Optional[Tuple[str, int]] = None
        self.handshake_rejects = 0
        self._pending_conns: Deque[FrameStream] = deque()
        self._conn_waiters: Deque[asyncio.Future] = deque()
        # the cluster's one ActuationModel (residency.py): proxies carry
        # it so autoscaler cold-start derivation works over proc too
        ecfg = engine_cfg or EngineConfig()
        self._actuation_model = ActuationModel(
            actuation_delay=ecfg.actuation_delay,
            load_on_switch=ecfg.load_on_switch, hw=ecfg.hw)
        self.proxies = [ReplicaProxy(rid, n, profile, self)
                        for rid, n in enumerate(counts)]
        self.coord = ClusterCoordinator(
            self.proxies, make_placement(placement),
            placement_seed=placement_seed,
            forecast=coordinator_forecast(autoscale, forecast))
        self.autoscaler = None
        self._autoscale_errors = 0
        self._scale_task: Optional[asyncio.Task] = None
        self._spawn_workers = counts[0]
        if autoscale is not None:
            if len(counts) > autoscale.max_replicas:
                raise ValueError(
                    f"{len(counts)} initial replicas exceed "
                    f"max_replicas={autoscale.max_replicas}")
            if autoscale.spawn_workers is None and len(set(counts)) > 1:
                raise ValueError(
                    "heterogeneous worker pools need an explicit "
                    "AutoscaleConfig.spawn_workers")
            if autoscale.spawn_workers:
                self._spawn_workers = autoscale.spawn_workers
            self.autoscaler = ClusterAutoscaler(
                self.coord, autoscale, self._spawn_proxy, slo=slo,
                migrate_fn=self._on_decommission)
        self._qid = 0
        self._started = False
        self._closing = False
        self._chans: List[_Channel] = []
        self._futs: Dict[int, asyncio.Future] = {}
        self._payloads: Dict[int, Any] = {}
        # qid index over the master list: drain resolves leftovers via
        # this instead of a linear scan of coord.queries per qid
        self._by_qid: Dict[int, Query] = {}
        self._all_done = asyncio.Event()
        self._all_done.set()

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> None:
        if self._listen_req is not None:
            await self._start_listener()
        for rid in range(len(self._counts)):
            self._chans.append(_Channel(rid))
            await self._connect_child(rid)
        self._started = True
        if self.autoscaler is not None:
            self.autoscaler.anchor(self.clock.now())
            self._scale_task = asyncio.get_running_loop().create_task(
                self._autoscale_loop())

    async def _start_listener(self) -> Tuple[str, int]:
        """Open the TCP front door (idempotent); resolves port 0 to the
        kernel-assigned port and returns the bound address."""
        if self._server is None:
            host, port = self._listen_req
            self._server = await asyncio.start_server(
                self._on_tcp_connect, host, port)
            sockname = self._server.sockets[0].getsockname()
            self.listen_addr = (sockname[0], int(sockname[1]))
        return self.listen_addr

    async def _on_tcp_connect(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> None:
        """Accept path: challenge/auth handshake, then hand the stream
        to whichever spawn/adopt call is waiting for a child (or park
        it for the next one). Rejected peers never reach pairing."""
        stream = FrameStream(reader, writer)
        nonce = secrets.token_hex(16)
        try:
            await stream.send({"t": "challenge", "nonce": nonce,
                               "version": PROTOCOL_VERSION})
            auth = await asyncio.wait_for(stream.recv(),
                                          timeout=HANDSHAKE_TIMEOUT_S)
        except (FrameError, ConnectionError, OSError,
                asyncio.TimeoutError):
            stream.close()
            return
        ok, reason = self._verify_auth(auth, nonce)
        if not ok:
            self.handshake_rejects += 1
            try:
                await stream.send({"t": "reject", "reason": reason})
            except (ConnectionError, OSError, RuntimeError):
                pass
            stream.close()
            return
        while self._conn_waiters:
            fut = self._conn_waiters.popleft()
            if not fut.done():
                fut.set_result(stream)
                return
        self._pending_conns.append(stream)

    def _verify_auth(self, auth: Optional[Dict[str, Any]],
                     nonce: str) -> Tuple[bool, str]:
        if auth is None or auth.get("t") != "auth":
            return False, f"expected an auth frame, got {auth!r}"
        if auth.get("version") != PROTOCOL_VERSION:
            return False, (
                f"protocol version mismatch: coordinator speaks "
                f"{PROTOCOL_VERSION}, peer sent {auth.get('version')!r}")
        mac = auth.get("mac")
        if not isinstance(mac, str) or not hmac.compare_digest(
                mac, auth_mac(self.token, nonce)):
            return False, "bad or missing token (HMAC mismatch)"
        return True, ""

    async def _await_child_conn(self, timeout: float) -> FrameStream:
        if self._pending_conns:
            return self._pending_conns.popleft()
        fut = asyncio.get_running_loop().create_future()
        self._conn_waiters.append(fut)
        return await asyncio.wait_for(fut, timeout)

    async def _connect_child(self, rid: int) -> None:
        """Bring replica ``rid``'s child up on the configured transport:
        fork over a socketpair, or fork-and-dial through the TCP
        listener (same handshake a remote child passes)."""
        ch = self._chans[rid]
        spec = ReplicaSpec(**{**self.spec.to_wire(),
                              "n_workers": self._counts[rid]})
        t0 = time.monotonic()
        if self._listen_req is None:
            ch.proc = spawn_replica_proc(spec, rid)
            sock = ch.proc._ipc_sock        # type: ignore[attr-defined]
            reader, writer = await asyncio.open_connection(sock=sock)
            stream = FrameStream(reader, writer)
        else:
            ch.proc = spawn_replica_proc_tcp(spec, self.listen_addr,
                                             self.token, rid)
            stream = await self._await_child_conn(self._spawn_timeout)
        await self._attach(ch, stream, spec)
        ch.spawn_s = time.monotonic() - t0

    async def _attach(self, ch: _Channel, stream: FrameStream,
                      spec: ReplicaSpec) -> None:
        """Shared spawn/adopt tail: config/hello exchange, then the
        channel's pump tasks take over the stream."""
        ch.stream = stream
        await stream.send(
            {"t": "config", "rid": ch.rid, "spec": spec.to_wire()})
        hello = await asyncio.wait_for(stream.recv(),
                                       timeout=self._spawn_timeout)
        if hello is None or hello.get("t") != "hello":
            raise MalformedFrame(
                f"replica {ch.rid}: expected hello, got {hello!r}")
        ch.hello = hello
        loop = asyncio.get_running_loop()
        ch.tasks = [loop.create_task(self._send_loop(ch)),
                    loop.create_task(self._read_loop(ch)),
                    loop.create_task(self._watchdog(ch))]

    async def adopt_replica(self, n_workers: int = 1,
                            timeout: Optional[float] = None) -> int:
        """Admit a REMOTE child into the cluster: wait for the next
        authenticated TCP connection (a ``replica_proc --connect``
        started on another host), register it as a new ready replica,
        and return its rid. The adopted process belongs to its own
        host — ``kill_replica``/shutdown close its stream rather than
        SIGKILLing a pid the coordinator doesn't own."""
        if self._listen_req is None:
            raise ValueError("adopt_replica needs listen= (the TCP "
                             "front door remote children dial)")
        await self._start_listener()
        stream = await self._await_child_conn(
            timeout if timeout is not None else self._spawn_timeout)
        rid = len(self.proxies)
        self._counts.append(n_workers)
        proxy = ReplicaProxy(rid, n_workers, self.profile, self)
        self.proxies.append(proxy)
        ch = _Channel(rid)
        self._chans.append(ch)
        self.coord.add_replica(proxy, ready=True)
        if self.autoscaler is not None:
            # adopted capacity bills from adoption (span parallels the
            # autoscaler's own spawns so replica_spans stays total)
            self.autoscaler._spans.setdefault(
                rid, [self.clock.now(), None])
        spec = ReplicaSpec(**{**self.spec.to_wire(),
                              "n_workers": n_workers})
        await self._attach(ch, stream, spec)
        return rid

    # -- live autoscaling (coordinator-owned lifecycle) -----------------

    def _spawn_proxy(self, rid: int) -> ReplicaProxy:
        """Autoscaler ``engine_factory``: register the coordinator-side
        stand-in synchronously (the autoscaler's spawn bookkeeping is
        sync); the control loop forks/connects the actual child right
        after the tick returns."""
        assert len(self.proxies) == rid == len(self._chans)
        self._counts.append(self._spawn_workers)
        proxy = ReplicaProxy(rid, self._spawn_workers, self.profile, self)
        self.proxies.append(proxy)
        self._chans.append(_Channel(rid))
        return proxy

    async def _autoscale_loop(self) -> None:
        """Live control loop: the proc twin of the inproc
        ``ClusterRouter._autoscale_loop``. Spawn events fork/connect a
        replica process, then schedule activation at ``ready_at`` — a
        spawned replica turns routable only once BOTH the cold start
        has elapsed and its child finished the handshake. Tick errors
        are counted (``stats()['autoscale_errors']``) and tolerated up
        to ``AUTOSCALE_MAX_CONSEC`` consecutive failures."""
        cfg = self.autoscaler.cfg
        loop = asyncio.get_running_loop()
        consecutive = 0
        while True:
            await asyncio.sleep(cfg.interval)
            try:
                for ev in self.autoscaler.tick(self.clock.now()):
                    if ev.kind == "spawn":
                        try:
                            await self._connect_child(ev.rid)
                        except Exception:
                            # stillborn child: never routable — book the
                            # death so it can't warm (and bill) forever
                            self.coord.alive[ev.rid] = False
                            self.autoscaler.on_death(ev.rid,
                                                     self.clock.now())
                            raise
                        loop.call_later(
                            max(ev.ready_at - self.clock.now(), 0.0),
                            self._activate, ev.rid)
                    # decommission: tick already re-routed the queue and
                    # asked the child to drain via _on_decommission
                consecutive = 0
            except Exception:           # noqa: BLE001 — keep scaling alive
                traceback.print_exc()
                self._autoscale_errors += 1
                consecutive += 1
                if consecutive >= self.AUTOSCALE_MAX_CONSEC:
                    raise

    def _activate(self, rid: int) -> None:
        """Cold start paid: the spawned replica becomes routable (a
        replica that died mid-warm-up stays down)."""
        if self.coord.alive[rid]:
            self.autoscaler.activate(rid, self.clock.now())

    def _on_decommission(self, rid: int, moved) -> None:
        """Autoscaler ``migrate_fn``: payloads and futures live parent-
        side keyed by qid, so nothing migrates — the redistribute that
        preceded this call already re-serialized the orphans to the
        survivors through ``ReplicaProxy.admit``. What remains is the
        child's retirement: a ``drain`` frame (its in-flight batches
        finish; their completions arrive stale and are ignored), then a
        background reap."""
        ch = self._chans[rid]
        if ch.stream is not None:
            ch.outbox.put_nowait({"t": "drain", "timeout": 10.0})
            try:
                asyncio.get_running_loop().create_task(self._reap(ch))
            except RuntimeError:
                ch.stop()               # no loop: hard stop

    async def _reap(self, ch: _Channel) -> None:
        try:
            await asyncio.wait_for(ch.drained.wait(), timeout=15.0)
        except asyncio.TimeoutError:
            pass
        ch.stop()
        if ch.proc is not None:
            try:
                await asyncio.to_thread(ch.proc.wait, 5.0)
            except subprocess.TimeoutExpired:
                ch.proc.kill()

    # -- admission (coordinator-owned, frame-forwarded) -----------------

    async def submit(self, payload: Any, slo_s: float) -> asyncio.Future:
        now = self.clock.now()
        q = Query(deadline=now + slo_s, seq=0, arrival=now, qid=self._qid)
        self._qid += 1
        self.coord.queries.append(q)
        self.coord.observe(q)
        fut = asyncio.get_running_loop().create_future()
        if not self.coord.alive_replicas():
            q.dropped = True
            fut.set_result((None, 0.0))
            return fut
        self._futs[q.qid] = fut
        self._payloads[q.qid] = payload
        self._by_qid[q.qid] = q
        self._all_done.clear()
        rid = self.coord.select(q, now)
        self.proxies[rid].admit(q)
        return fut

    def _send_submit(self, rid: int, q: Query) -> None:
        """Proxy admission hook (sync — also called from the coordinator
        re-route path): enqueue a submit frame carrying the *remaining*
        SLO, so a re-routed query's deadline naturally shrinks."""
        slo = q.deadline - self.clock.now()
        self._chans[rid].outbox.put_nowait(
            {"t": "submit", "qid": q.qid, "slo": slo,
             "payload": to_jsonable(self._payloads.get(q.qid))})

    # -- frame plumbing -------------------------------------------------

    async def _send_loop(self, ch: _Channel) -> None:
        while True:
            frame = await ch.outbox.get()
            if frame is None:
                return
            try:
                await ch.stream.send(frame)
            except (ConnectionError, RuntimeError, OSError):
                self._on_death(ch.rid, "send failed")
                return

    async def _read_loop(self, ch: _Channel) -> None:
        reason = "eof"
        try:
            while True:
                frame = await ch.stream.recv()
                if frame is None:
                    break
                t = frame["t"]
                if t == "completion":
                    self._on_completion(ch.rid, frame)
                elif t == "stats":
                    self.proxies[ch.rid].refresh(
                        frame.get("counters", {}))
                    ch.stats_ready.set()
                elif t == "drained":
                    self.proxies[ch.rid].refresh(
                        frame.get("counters", {}))
                    ch.drained.set()
                # heartbeats need no handling: recv stamped last_rx
        except FrameError as e:
            ch.protocol_error = e
            reason = f"protocol error: {e}"
        except (ConnectionError, OSError) as e:
            reason = f"connection lost: {e}"
        finally:
            self._on_death(ch.rid, reason)

    async def _watchdog(self, ch: _Channel) -> None:
        """Dead-peer detection: a silent child (no frames, no
        heartbeats) is declared dead and its work re-routed."""
        dead_after = self.spec.heartbeat_s * DEAD_AFTER_BEATS
        while True:
            await asyncio.sleep(self.spec.heartbeat_s)
            if time.monotonic() - ch.stream.last_rx > dead_after:
                self._on_death(ch.rid, "heartbeat timeout")
                return

    # -- completion / death ---------------------------------------------

    def _on_completion(self, rid: int, frame: Dict[str, Any]) -> None:
        qid = frame.get("qid")
        q = self.proxies[rid].pending.pop(qid, None)
        if q is None:
            return      # re-routed away meanwhile: stale completion
        if frame.get("dropped"):
            q.dropped = True
            q.timed_out = bool(frame.get("timed_out"))
        else:
            # master finish stamped at receipt: end-to-end, IPC included
            q.finish = self.clock.now()
            q.served_acc = frame.get("acc")
        self._resolve(qid, (frame.get("pred"), frame.get("acc") or 0.0)
                      if not frame.get("dropped") else (None, 0.0))

    def _resolve(self, qid: int, result) -> None:
        self._payloads.pop(qid, None)
        self._by_qid.pop(qid, None)
        fut = self._futs.pop(qid, None)
        if fut is not None and not fut.done():
            fut.set_result(result)
        if not self._futs:
            self._all_done.set()

    def _on_death(self, rid: int, reason: str) -> None:
        """Funnel every death signal (kill, EOF, protocol error,
        heartbeat loss) into the coordinator's one surrender path:
        ``redistribute`` re-routes the orphans through placement, the
        proxies' ``admit`` re-serializes them to the survivors. With no
        survivor left the orphans drop — their futures still resolve.

        During shutdown (``drain`` in flight, ``_closing`` set) the
        redistribute is skipped: the "survivors" have already acked
        ``drained`` and exited their serve loops, so re-routed submit
        frames would vanish into dead sockets and sit unresolved until
        the drain timeout misclassified them as ``timed_out``. Shutdown
        orphans resolve immediately as dropped shutdown loss instead
        (``timed_out`` stays False: they were lost to a death, not to
        the drain deadline)."""
        ch = self._chans[rid]
        ch.stop()
        if not self.coord.alive[rid]:
            return
        proxy = self.proxies[rid]
        proxy.residency.clear()         # no workers left on a dead peer
        if self._closing:
            self.coord.alive[rid] = False
            for q in list(proxy.pending.values()):
                q.dropped = True
                self._resolve(q.qid, (None, 0.0))
            proxy.pending.clear()
            return
        snapshot = list(proxy.pending.values())
        self.coord.redistribute(rid, self.clock.now())
        for q in snapshot:
            if q.dropped:               # no survivors took it
                self._resolve(q.qid, (None, 0.0))
        if self.autoscaler is not None:
            # mirror the inproc _book_death: close the billing span and
            # forget a still-warming victim
            self.autoscaler.on_death(rid, self.clock.now())

    # -- fault injection -------------------------------------------------

    def kill_worker(self, rid: int, wid: int) -> None:
        """Mirror the inproc path: fault one remote worker; when the
        pool empties the replica is decommissioned (its process killed)
        and its queue re-routed."""
        self.proxies[rid].fault(wid)
        if self.coord.should_decommission(rid):
            self._on_death(rid, "last worker killed")
        elif self.coord.alive[rid]:
            self._chans[rid].outbox.put_nowait({"t": "kill", "wid": wid})

    def kill_replica(self, rid: int) -> None:
        """Hard replica death: SIGKILL the process (close the stream
        for adopted replicas — their pid belongs to another host), then
        drain-and-re-route immediately (the EOF path then finds it
        already dead and no-ops)."""
        ch = self._chans[rid]
        if ch.proc is not None:
            ch.proc.kill()
        elif ch.stream is not None:
            ch.stream.close()
        self._on_death(rid, "killed")

    # -- shutdown --------------------------------------------------------

    async def drain(self, timeout: float = 10.0) -> None:
        """Ask every live child to drain, wait (event-driven) for all
        outstanding futures, then reap. Queries still unresolved at the
        deadline resolve as dropped AND ``timed_out`` — the same
        shutdown-loss marking as the inproc ``Router.drain``."""
        self._closing = True
        if self._scale_task is not None:
            self._scale_task.cancel()
            self._scale_task = None
        deadline = time.monotonic() + timeout
        for ch in self._chans:
            if self.coord.alive[ch.rid] and ch.stream is not None:
                ch.outbox.put_nowait({"t": "drain", "timeout": timeout})
        try:
            await asyncio.wait_for(self._all_done.wait(),
                                   timeout=max(deadline - time.monotonic(),
                                               0.001))
            expired = False
        except asyncio.TimeoutError:
            expired = True
        for ch in self._chans:
            if self.coord.alive[ch.rid] and ch.stream is not None:
                try:
                    await asyncio.wait_for(
                        ch.drained.wait(),
                        timeout=max(deadline - time.monotonic(), 0.001))
                except asyncio.TimeoutError:
                    pass
        for qid in list(self._futs):
            q = self._by_qid.get(qid)
            if q is not None:
                q.dropped = True
                q.timed_out = expired
            self._resolve(qid, (None, 0.0))
        for proxy in self.proxies:
            proxy.pending.clear()
        for ch in self._chans:
            ch.stop()
            if ch.proc is not None:
                try:
                    ch.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    ch.proc.kill()
        for fut in self._conn_waiters:
            fut.cancel()
        self._conn_waiters.clear()
        for stream in self._pending_conns:
            stream.close()
        self._pending_conns.clear()
        if self._server is not None:
            self._server.close()
            self._server = None

    async def refresh_stats(self, timeout: float = 5.0) -> None:
        """Pull live counters from every alive child into the proxies,
        so the inherited ``stats()`` aggregates real child numbers."""
        waits = []
        for ch in self._chans:
            if self.coord.alive[ch.rid] and ch.stream is not None:
                ch.stats_ready.clear()
                ch.outbox.put_nowait({"t": "stats"})
                waits.append(ch.stats_ready.wait())
        if waits:
            await asyncio.wait([asyncio.ensure_future(w) for w in waits],
                               timeout=timeout)

    # -- surfaces that do not cross the boundary -------------------------

    def run_virtual(self, *a, **kw):
        raise NotImplementedError(
            "run_virtual is the inproc parity path; the proc transport "
            "is wall-clock only (its parity bar is tests/test_ipc.py)")
