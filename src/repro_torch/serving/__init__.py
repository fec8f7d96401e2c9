"""SuperServe serving layer for the port.

Copied from ``repro.serving`` (only imports and wording differ): the
profiler, EDF queue, scheduling policies, the one transport-agnostic
engine, traces, metrics, residency and forecast; the discrete-event
simulator (``simulate``, ``simulate_cluster``); the cluster coordinator
with its placements (``cluster.py``) and the replica autoscaler
(``autoscaler.py``); the asyncio ``Router`` and the ``ClusterRouter``
front door over N replica groups (``runtime.py``).

Ported, with the port's changes: the proc transport (``ipc.py``: the
same frame protocol and HMAC handshake, a spec that carries the
executor's device, size, units and slice mode) and its replica child
(``replica_proc.py``, which builds a warmed executor on its card and
reports its kernel builds and launches); and the torch subnet executor
(``executor.py``, with ``build_serving_executor`` for children).
"""
