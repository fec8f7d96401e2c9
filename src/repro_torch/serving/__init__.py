"""SuperServe serving layer for the port: the scheduling stack copied from
``repro.serving`` (profiler, EDF queue, policies, engine, traces, metrics,
residency, forecast, the single-replica asyncio Router) and the torch
subnet executor."""
