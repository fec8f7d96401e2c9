"""Replica worker-process entrypoint for the proc transport
(serving/ipc.py).

Two front doors, one serve loop:

* ``python -m repro_torch.serving.replica_proc --fd N`` — local child over an
  inherited socketpair (trusted fd, no handshake);
* ``python -m repro_torch.serving.replica_proc --connect HOST:PORT
  [--token T]`` — dial a coordinator's TCP listener from ANY host,
  answer its HMAC challenge (token from ``--token`` or the
  ``REPRO_IPC_TOKEN`` env var), and serve once admitted. A ``reject``
  frame (bad token, version mismatch) exits with a diagnostic.

Either way the first serving frame (``config``) carries a
``ReplicaSpec``, from which the child builds one full ``Router`` — its
own ``SchedulingEngine``, policy (rebuilt by registry name), worker
pool, and wall clock — then answers ``submit`` frames with
``completion`` frames as futures resolve, heartbeating in between.

Execution: ``spec.execute == "echo"`` serves echo workers with an
optional CPU spin (the scale-out benchmark's stand-in);
``spec.execute == "real"`` builds a ``SubnetExecutor`` in-child through
``build_serving_executor`` on ``spec.device`` at ``spec.size``,
``units`` and ``slice_mode`` (serving/executor.py), so completion
frames carry real subnet logits and the engine's batch latencies are
real forward passes. A child that cannot find its card, build the
kernels or launch one dies, and its death reaches the coordinator as a
replica death: nothing falls back to echo workers or to the CPU.

Device pinning: the parent spawns this process under
``compat.child_env``, whose ``CUDA_VISIBLE_DEVICES`` names one of the
parent's visible cards, so the child's ``cuda`` is that card. Its
``hello`` frame reports the cards it sees (``None`` on the CPU) and the
card's name; its ``stats`` and ``drained`` counters report the kernel
builds and CUDA-graph captures made after warmup (0 when warm) and the
kernel launches, so the no-build-after-warmup gate holds in every child.

A port of ``repro/serving/replica_proc.py``.

Scheduling stays engine-owned: the child's router drops infeasible
queries, forms batches, and re-enqueues on worker faults exactly as
inproc; the parent only learns outcomes through completion frames.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import socket
import threading
import time
from typing import Any, List, Optional

from repro_torch import compat
from repro_torch.serving.ipc import (PROTOCOL_VERSION, TOKEN_ENV, FrameStream,
                               MalformedFrame, ReplicaSpec, auth_mac,
                               heartbeat_loop, engine_cfg_from_wire,
                               profile_from_wire, to_jsonable, KILL_ALL)
from repro_torch.serving.policies import ALL_POLICIES
from repro_torch.serving.queue import Query
from repro_torch.serving.runtime import Router, WorkerHandle


def make_worker_run(work_ms: float):
    """Echo worker with an optional busy-spin: ``work_ms`` of real CPU
    per batch stands in for model execution, so the scale-out benchmark
    measures genuine multi-core parallelism (an inproc cluster's worker
    threads serialize this spin on the GIL; processes don't)."""

    def run(pareto_idx: int, payloads: List[Any]) -> List[Any]:
        if work_ms > 0:
            t_end = time.perf_counter() + work_ms / 1e3
            while time.perf_counter() < t_end:
                pass
        return list(payloads)

    return run


def make_real_workers(spec: ReplicaSpec,
                      steps: Optional[dict] = None) -> List[WorkerHandle]:
    """``execute="real"``: build the in-child ``SubnetExecutor`` from
    the wire spec — the arch's config at ``spec.size`` and ``units`` on
    ``spec.device`` in ``spec.slice_mode``, warmed on the (1,2,4,8) x
    seq_len bucket lattice — and wrap its subnets as the worker pool.
    The coordinator's wire profile must schedule the same Pareto set the
    executor serves, or accuracies/subnet indices would silently
    disagree across the boundary. ``steps``, when given, adds up the
    wall seconds of the workers' steps (``n``, ``s``): each ends with the
    logits on the host, so the device is done."""
    from repro_torch.serving.executor import build_serving_executor
    ex = build_serving_executor(spec.arch, seq_len=spec.seq_len,
                                seed=spec.seed, device=spec.device,
                                size=spec.size, units=spec.units,
                                slice_mode=spec.slice_mode)
    profile = profile_from_wire(spec.profile)
    if ex.n_subnets != profile.lat.shape[0]:
        raise ValueError(
            f"executor serves {ex.n_subnets} pareto subnets but the wire "
            f"profile schedules {profile.lat.shape[0]}: build the "
            f"coordinator's profile from the SAME config "
            f"(serving_config({spec.arch!r}, {spec.device!r}, "
            f"{spec.size!r}, {spec.units!r}))")
    workers = ex.make_workers(spec.n_workers)
    if steps is not None:
        lock = threading.Lock()
        for w in workers:
            w.run = _timed(w.run, steps, lock)
    return workers


def _timed(run, steps: dict, lock: threading.Lock):
    def timed_run(pareto_idx: int, payloads: List[Any]):
        t0 = time.perf_counter()
        out = run(pareto_idx, payloads)
        with lock:                  # worker threads share ``steps``
            steps["n"] += 1
            steps["s"] += time.perf_counter() - t0
        return out
    return timed_run


def build_router(spec: ReplicaSpec, rid: int,
                 steps: Optional[dict] = None) -> Router:
    profile = profile_from_wire(spec.profile)
    policy = ALL_POLICIES[spec.policy]()
    if spec.execute == "real":
        workers = make_real_workers(spec, steps)
    else:
        workers = [WorkerHandle(wid=i, run=make_worker_run(spec.work_ms))
                   for i in range(spec.n_workers)]
    return Router(profile, policy,
                  workers, engine_cfg=engine_cfg_from_wire(spec.engine_cfg),
                  replica_id=rid)


def _counters(router: Router, hb_errors: Optional[dict] = None,
              builds0: int = 0, captures0: int = 0,
              sends: Optional[dict] = None,
              steps: Optional[dict] = None) -> dict:
    eng = router.engine
    steps = steps or {}
    return {
        # kernel builds and launches since warmup ended (a warm child
        # reports 0 builds)
        "kernel_builds": compat.builds() - builds0,
        "graph_captures": compat.captures() - captures0,
        "kernel_launches": compat.launch_counts(),
        "completion_frames": int((sends or {}).get("frames", 0)),
        "completion_send_s": float((sends or {}).get("seconds", 0.0)),
        "steps": int(steps.get("n", 0)),
        "step_s": float(steps.get("s", 0.0)),
        "n_joins": int(eng.n_joins),
        "n_switches": int(eng.residency.n_switches),
        "n_launches": int(eng.residency.n_launches),
        "actuation_seconds": float(eng.residency.actuation_seconds),
        "heartbeat_send_errors": int(
            (hb_errors or {}).get("heartbeat_send_errors", 0)),
        "stats": to_jsonable(router.stats()),
    }


async def serve(stream: FrameStream,
                cfg_frame: Optional[dict] = None) -> None:
    """The serve loop, transport-agnostic: ``cfg_frame`` is the already-
    received config when the TCP handshake consumed the stream head."""
    cfg = cfg_frame if cfg_frame is not None else await stream.recv()
    if cfg is None or cfg.get("t") != "config":
        raise MalformedFrame(f"expected a config frame, got {cfg!r}")
    spec = ReplicaSpec.from_wire(cfg["spec"])
    rid = int(cfg.get("rid", 0))

    devices: Optional[int] = None
    card: Optional[str] = None
    if spec.execute == "real" and spec.device == "cuda":
        import torch
        devices = torch.cuda.device_count()
        card = torch.cuda.get_device_name(0) if devices else None

    steps = {"n": 0, "s": 0.0}
    t0 = time.perf_counter()
    router = build_router(spec, rid, steps)
    init_s = time.perf_counter() - t0
    # what serving adds from here on: builds and captures (0 when warm)
    # and launches
    builds0, captures0 = compat.builds(), compat.captures()
    compat.reset_launch_counts()
    await router.start()
    await stream.send({"t": "hello", "rid": rid, "pid": os.getpid(),
                       "n_workers": spec.n_workers, "devices": devices,
                       "device_name": card, "init_s": init_s,
                       "execute": spec.execute})
    sends = {"frames": 0, "seconds": 0.0}

    hb_errors: dict = {}
    hb = asyncio.create_task(
        heartbeat_loop(stream, spec.heartbeat_s, errors=hb_errors))
    inflight: set = set()

    async def run_one(frame: dict) -> None:
        now = router.clock.now()
        q = Query(deadline=now + float(frame["slo"]), seq=0, arrival=now,
                  qid=int(frame["qid"]))
        fut = await router.submit_query(q, frame.get("payload"))
        pred, acc = await fut
        t_send = time.perf_counter()
        await stream.send({
            "t": "completion", "qid": q.qid,
            "dropped": bool(q.dropped), "timed_out": bool(q.timed_out),
            "acc": None if q.dropped else float(acc),
            "latency": (q.finish - q.arrival
                        if q.finish is not None else None),
            "pred": to_jsonable(pred)})
        sends["frames"] += 1
        sends["seconds"] += time.perf_counter() - t_send

    try:
        while True:
            frame = await stream.recv()
            if frame is None:
                break                   # parent gone: exit quietly
            t = frame["t"]
            if t == "submit":
                task = asyncio.create_task(run_one(frame))
                inflight.add(task)
                task.add_done_callback(inflight.discard)
            elif t == "kill":
                wid = int(frame.get("wid", KILL_ALL))
                wids = ([w.wid for w in router.workers]
                        if wid == KILL_ALL else [wid])
                for w in wids:
                    router.kill_worker(w)
            elif t == "stats":
                await stream.send({"t": "stats",
                                   "counters": _counters(router, hb_errors,
                                                         builds0, captures0,
                                                         sends,
                                                         steps)})
            elif t == "drain":
                await router.drain(float(frame.get("timeout", 10.0)))
                # flush every pending completion before acking the drain
                if inflight:
                    await asyncio.gather(*list(inflight),
                                         return_exceptions=True)
                await stream.send({"t": "drained",
                                   "counters": _counters(router, hb_errors,
                                                         builds0, captures0,
                                                         sends,
                                                         steps)})
                break
            # unknown kinds are ignored: additive protocol evolution
    finally:
        hb.cancel()
        stream.close()


async def serve_fd(fd: int) -> None:
    sock = socket.socket(fileno=fd)
    reader, writer = await asyncio.open_connection(sock=sock)
    await serve(FrameStream(reader, writer))


async def serve_tcp(host: str, port: int, token: str) -> None:
    """Dial the coordinator's listener and run its handshake: recv
    ``challenge`` (nonce + protocol version), answer ``auth`` with
    ``HMAC(token, nonce:version)``, then the next frame is either a
    ``reject`` (exit with its reason) or the ``config`` that starts the
    serve loop."""
    reader, writer = await asyncio.open_connection(host, port)
    stream = FrameStream(reader, writer)
    challenge = await stream.recv()
    if challenge is None or challenge.get("t") != "challenge":
        raise MalformedFrame(
            f"expected a challenge frame, got {challenge!r}")
    version = challenge.get("version")
    if version != PROTOCOL_VERSION:
        stream.close()
        raise SystemExit(
            f"protocol version mismatch: coordinator speaks {version!r}, "
            f"this child speaks {PROTOCOL_VERSION}")
    await stream.send({"t": "auth", "version": PROTOCOL_VERSION,
                       "mac": auth_mac(token, challenge.get("nonce") or "")})
    first = await stream.recv()
    if first is None or first.get("t") == "reject":
        stream.close()
        reason = (first or {}).get("reason", "connection closed")
        raise SystemExit(f"coordinator rejected the handshake: {reason}")
    await serve(stream, cfg_frame=first)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="serve one replica group for a proc-transport "
                    "coordinator (local --fd or remote --connect)")
    p.add_argument("--fd", type=int, default=None,
                   help="inherited socketpair fd connected to the "
                        "coordinator process (local spawn)")
    p.add_argument("--connect", default=None, metavar="HOST:PORT",
                   help="dial the coordinator's TCP listener instead of "
                        "inheriting a socket (remote replica)")
    p.add_argument("--token", default=None,
                   help="shared HMAC token for the --connect handshake "
                        f"(default: ${TOKEN_ENV})")
    args = p.parse_args(argv)
    if (args.fd is None) == (args.connect is None):
        p.error("exactly one of --fd (inherited socketpair) or "
                "--connect HOST:PORT (TCP) is required")
    if args.fd is not None:
        asyncio.run(serve_fd(args.fd))
        return
    host, _, port = args.connect.rpartition(":")
    if not host or not port.isdigit():
        p.error(f"--connect wants HOST:PORT, got {args.connect!r}")
    token = (args.token if args.token is not None
             else os.environ.get(TOKEN_ENV, ""))
    asyncio.run(serve_tcp(host, int(port), token))


if __name__ == "__main__":
    main()
