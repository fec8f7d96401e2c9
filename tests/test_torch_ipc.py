"""The proc transport of the port (``serving/ipc.py`` and
``serving/replica_proc.py``): the wire is the JAX package's, byte for
byte; the port's replica spec differs only by its own fields; children
run under the port's environment (no ``JAX_PLATFORMS``, never an empty
``CUDA_VISIBLE_DEVICES``); and live children serve the in-process
records (socketpair), pass or fail the HMAC handshake (TCP), and return
the logits of the port's in-process executor. Four child processes in
all."""
import asyncio
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serving import engine as jengine
from repro.serving import forecast as jforecast
from repro.serving import ipc as jipc
from repro.serving import profiler as jprofiler
from repro_torch import compat
from repro_torch.configs import get_config as tget_config
from repro_torch.serving import engine as tengine
from repro_torch.serving import forecast as tforecast
from repro_torch.serving import ipc as tipc
from repro_torch.serving import policies as tpolicies
from repro_torch.serving import profiler as tprofiler
from repro_torch.serving.runtime import ClusterRouter, WorkerHandle

PORT_SPEC_FIELDS = {"device", "size", "units", "slice_mode"}
FRAMES = [
    {"t": "submit", "qid": 3, "slo": 0.125, "payload": [1, 2, 3]},
    {"t": "completion", "qid": 7, "dropped": False, "timed_out": False,
     "acc": 79.5, "latency": 0.0123,
     "pred": np.linspace(-2, 2, 9, dtype=np.float32)},
    {"t": "hello", "rid": 1, "pid": 42, "n_workers": 2, "devices": None,
     "execute": "echo"},
    {"t": "kill", "wid": -1},
]


# --------------------------------------------------------------------------
# The wire
# --------------------------------------------------------------------------


def test_protocol_constants_match_repro():
    for name in ("HEADER_BYTES", "MAX_FRAME", "HEARTBEAT_S",
                 "DEAD_AFTER_BEATS", "KILL_ALL", "PROTOCOL_VERSION",
                 "HANDSHAKE_TIMEOUT_S", "TOKEN_ENV"):
        assert getattr(tipc, name) == getattr(jipc, name), name
    assert tipc.MAX_FRAME == 8 << 20
    assert tipc.auth_mac("tok", "nonce") == jipc.auth_mac("tok", "nonce")
    assert tipc.auth_mac("tok", "n", 9) == jipc.auth_mac("tok", "n", 9)


@pytest.mark.parametrize("seq", [0, 5])
def test_frame_bytes_match_repro(seq):
    for frame in FRAMES:
        jf = {k: jipc.to_jsonable(v) for k, v in frame.items()}
        tf = {k: tipc.to_jsonable(v) for k, v in frame.items()}
        data = tipc.encode_frame(tf, seq)
        assert data == jipc.encode_frame(jf, seq)
        # the port's decoder reads the reference's bytes back a byte at
        # a time, and refuses what the reference refuses
        dec = tipc.FrameDecoder(expect_seq=False)
        got = [f for b in data for f in dec.feed(bytes([b]))]
        assert got == [{**tf, "seq": seq}]
    with pytest.raises(tipc.OversizedFrame):
        tipc.encode_frame({"t": "x", "pad": "y" * 64}, 0, max_frame=32)
    dec = tipc.FrameDecoder()
    with pytest.raises(tipc.OutOfOrderFrame):
        dec.feed(jipc.encode_frame({"t": "x"}, 1))
    dec = tipc.FrameDecoder()
    dec.feed(jipc.encode_frame({"t": "x"}, 0)[:-2])
    with pytest.raises(tipc.TruncatedFrame):
        dec.eof()


def test_profile_engine_cfg_and_spec_on_the_wire_match_repro():
    for name, reduce in (("ofa_resnet", False), ("qwen2-1.5b", True)):
        jc, tc = jget_config(name), tget_config(name)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        jw = jipc.profile_to_wire(jprofiler.build_profile(jc))
        tw = tipc.profile_to_wire(tprofiler.build_profile(tc))
        assert tw == jw
        back = tipc.profile_from_wire(tw)
        np.testing.assert_array_equal(back.lat, np.asarray(jw["lat"]))
    jcfg = jengine.EngineConfig(continuous_batching=True,
                                predictive_joins=True, load_on_switch=True,
                                forecast=jforecast.ForecastConfig(window=0.3))
    tcfg = tengine.EngineConfig(continuous_batching=True,
                                predictive_joins=True, load_on_switch=True,
                                forecast=tforecast.ForecastConfig(window=0.3))
    assert tipc.engine_cfg_to_wire(tcfg) == jipc.engine_cfg_to_wire(jcfg)
    assert tipc.engine_cfg_to_wire(None) is None
    assert tipc.engine_cfg_from_wire(tipc.engine_cfg_to_wire(tcfg)) == tcfg
    common = dict(profile=jw, policy="slackfit", n_workers=2,
                  engine_cfg=jipc.engine_cfg_to_wire(jcfg), work_ms=1.5,
                  execute="real", arch="qwen2-1.5b", seq_len=8, seed=3)
    jspec = jipc.ReplicaSpec(**common).to_wire()
    tspec = tipc.ReplicaSpec(**common).to_wire()
    assert set(tspec) - set(jspec) == PORT_SPEC_FIELDS
    assert {k: tspec[k] for k in jspec} == jspec
    assert {k: tspec[k] for k in PORT_SPEC_FIELDS} == {
        "device": "cuda", "size": None, "units": None, "slice_mode": "mask"}
    assert tipc.ReplicaSpec.from_wire(tspec) == tipc.ReplicaSpec(**common)


# --------------------------------------------------------------------------
# Refusals and the child environment
# --------------------------------------------------------------------------

PROF = tprofiler.build_profile(tget_config("ofa_resnet"))


def test_host_devices_refused():
    with pytest.raises(ValueError, match="fake XLA host devices"):
        tipc.ReplicaSpec(profile={}, policy="maxacc", host_devices=2)
    with pytest.raises(ValueError, match="fake XLA host devices"):
        ClusterRouter(PROF, tpolicies.MaxAcc(), [1], transport="proc",
                      host_devices=2)


def test_child_env(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("CUDACXX", "toolkit/bin/nvcc")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    envs = [compat.child_env(rid, "cuda", PYTHONPATH="src")
            for rid in range(3)]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["3", "5", "3"]
    for env in envs:
        assert "JAX_PLATFORMS" not in env and "CUDA_HOME" not in env
        assert env["CUDACXX"] == "toolkit/bin/nvcc"
        assert env["PYTHONPATH"] == "src" and env["PATH"] and env["HOME"]
    # a CPU child is not pinned; with no card visible nothing is set,
    # never an empty CUDA_VISIBLE_DEVICES
    assert "CUDA_VISIBLE_DEVICES" not in compat.child_env(1, "cpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(compat.torch.cuda, "is_available", lambda: False)
    assert compat.visible_cards() == []
    assert "CUDA_VISIBLE_DEVICES" not in compat.child_env(0, "cuda")
    monkeypatch.setattr(compat.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(compat.torch.cuda, "device_count", lambda: 1)
    assert [compat.child_env(r, "cuda")["CUDA_VISIBLE_DEVICES"]
            for r in range(2)] == ["0", "0"]


# --------------------------------------------------------------------------
# Live children
# --------------------------------------------------------------------------

N_Q = 16


def _key(recs):
    """Which queries were served or dropped, at which accuracy, on which
    replica: the timing-free signature of a run."""
    return sorted((r.qid, r.dropped,
                   None if r.served_acc is None
                   else round(float(r.served_acc), 9), r.replica)
                  for r in recs)


async def _run_paced(router):
    await router.start()
    futs = []
    for i in range(N_Q):
        futs.append(await router.submit([float(i)], slo_s=10.0))
        await asyncio.sleep(0.004)
    results = await asyncio.gather(*futs)
    await router.drain(30.0)
    return router.records(), results


def test_socketpair_children_match_inproc_records():
    groups = [[WorkerHandle(wid=i, run=lambda idx, p: list(p))
               for i in range(2)] for _ in range(2)]
    recs_in, _ = asyncio.run(_run_paced(
        ClusterRouter(PROF, tpolicies.MaxAcc(), groups)))
    router = ClusterRouter(PROF, tpolicies.MaxAcc(), [2, 2],
                           transport="proc")
    recs, results = asyncio.run(_run_paced(router))
    assert len(recs) == N_Q
    assert _key(recs) == _key(recs_in)
    assert {r.replica for r in recs} == {0, 1}
    assert [pred for pred, _ in results] == [[float(i)] for i in range(N_Q)]
    for ch in router._chans:
        assert ch.hello["devices"] is None and ch.spawn_s > 0
        assert ch.proc.poll() is not None           # reaped


def test_bad_token_refused():
    async def main():
        router = ClusterRouter(PROF, tpolicies.MaxAcc(), [1],
                               transport="proc", listen="127.0.0.1:0",
                               token="sesame")
        await router._start_listener()
        try:
            host, port = router.listen_addr
            reader, writer = await asyncio.open_connection(host, port)
            stream = tipc.FrameStream(reader, writer)
            challenge = await stream.recv()
            await stream.send({"t": "auth", "version": tipc.PROTOCOL_VERSION,
                               "mac": tipc.auth_mac("WRONG",
                                                    challenge["nonce"])})
            reply = await asyncio.wait_for(stream.recv(), timeout=5.0)
            eof = await asyncio.wait_for(stream.recv(), timeout=5.0)
            return router, reply, eof
        finally:
            router._server.close()

    router, reply, eof = asyncio.run(main())
    assert reply["t"] == "reject" and "token" in reply["reason"]
    assert eof is None
    assert router.handshake_rejects == 1 and not router._pending_conns


def test_tcp_child_with_token_serves_through_the_launcher():
    """``--transport proc --listen`` with a token: one real child on the
    CPU dials the listener, passes the handshake and serves every query
    of the trace; it builds nothing after warmup."""
    from repro_torch.launch import serve
    out = serve.run(["--device", "cpu", "--transport", "proc", "--listen",
                     "127.0.0.1:0", "--token", "sesame", "--procs", "1",
                     "--queries", "8", "--seq-len", "8", "--rate", "40"])
    assert out["mode"] == "proc" and out["execute"] == "real"
    assert out["handshake_rejects"] == 0 and out["listen"][1] > 0
    assert out["served"] + out["dropped"] == out["queries"] == 8
    assert out["served"] == 8
    assert (out["device"], out["size"]) == ("cpu", "reduced")
    assert out["serve_phase_builds"] == 0
    (child,) = out["children"]
    assert child["kernel_builds"] == 0 and child["completion_frames"] == 8
    assert child["spawn_s"] > 0 and child["devices"] is None


def test_real_child_logits_match_inproc_executor():
    """``execute="real"`` on the CPU: the child builds the reduced
    qwen2-1.5b from the seed, and each completion's logits equal the
    port's in-process executor's on the same prompt at the subnet whose
    accuracy the completion reports."""
    from repro_torch.serving.executor import (build_serving_executor,
                                              serving_config)
    cfg = serving_config("qwen2-1.5b", "cpu")
    prof = tprofiler.build_profile(cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)

    async def main():
        router = ClusterRouter(prof, tpolicies.SlackFit(), [1],
                               transport="proc", execute="real",
                               arch="qwen2-1.5b", seq_len=8, seed=5,
                               device="cpu", spawn_timeout=300.0)
        await router.start()
        futs = [await router.submit(p.tolist(), slo_s=60.0) for p in prompts]
        results = await asyncio.gather(*futs)
        await router.drain(60.0)
        return router, results

    router, results = asyncio.run(main())
    assert all(not r.dropped for r in router.records())
    assert router._chans[0].hello["execute"] == "real"
    ex = build_serving_executor("qwen2-1.5b", seq_len=8, seed=5, device="cpu")
    accs = ex.accs()
    for prompt, (pred, acc) in zip(prompts, results):
        got = np.asarray(pred, dtype=np.float32)
        assert got.shape == (cfg.vocab_size,) and np.isfinite(got).all()
        idx = accs.index(acc)
        want = ex.prefill(idx, prompt[None])[0]
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    counters = router.proxies[0].child_stats
    assert counters["kernel_builds"] == 0
    assert counters["completion_frames"] == len(prompts)
    assert dataclasses.asdict(router.spec)["device"] == "cpu"
