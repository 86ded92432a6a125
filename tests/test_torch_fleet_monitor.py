"""The port's fleet layer (deepspeed_tpu_torch/monitor/ fleet.py,
health.py, heartbeat.py, capture.py) held against the JAX package's on
the same inputs: the window-vector codec, the aggregation records and
the straggler / divergence detector over the scripted window matrices of
tests/unit/test_fleet_monitor.py (its RiggedGather: an injected gather
that serves the matrices), the profiler capture's state machine with a
mock profiler and one real torch.profiler capture on the CPU, the
heartbeat files (each package reads the other's), and one end-to-end run
of two gloo processes: rank 1 measures its steps on a clock that runs 5x
(the slow host), and rank 0's fleet and health records name it, as the
JAX aggregator and detector do when fed the same window matrices.

The processes are this file run as a worker script: its top level imports
only torch, numpy and the port, never JAX; the test side imports JAX
lazily.  They join a gloo group through `init_distributed` and a
`file://` rendezvous under the test's temporary directory, one thread a
process, with a deadline after which they are killed."""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.config import MonitorConfig
from deepspeed_tpu_torch.models import GPT2Config, GPT2Model
from deepspeed_tpu_torch.monitor import (
    FleetAggregator, FleetHealth, HeartbeatWriter, ProfileCapture,
    TrainingMonitor, annotate_stale, attribute_straggler_lane,
    decode_window_vector, encode_window_vector, format_fleet_line,
    format_health_line, format_watch_table, read_heartbeats,
    resolve_heartbeat_dir, straggler_verdict, summarize_fleet)
from deepspeed_tpu_torch.monitor import monitor as monitor_mod
from deepspeed_tpu_torch.monitor import record as R
from deepspeed_tpu_torch.monitor.fleet import VEC_LEN, _encode_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
E2E_STEPS, E2E_WINDOW, SLOW_CLOCK = 8, 2, 5.0
TINY = dict(vocab_size=128, n_positions=64, hidden_size=32, num_layers=2,
            num_heads=4, embd_dropout=0.0, attn_dropout=0.0,
            hidden_dropout=0.0)


# ---------------------------------------------------------------------- #
# the worker: run as `python tests/test_torch_fleet_monitor.py SPEC RANK`
# ---------------------------------------------------------------------- #
class _FastClock:
    """The monitor's view of `time` on the slow rank: perf_counter runs
    SLOW_CLOCK times as fast, so every span it measures is that many
    times longer (the rest of `time` is the real module's)."""

    def __init__(self, real, factor):
        self._real, self._factor = real, factor

    def perf_counter(self):
        return self._real.perf_counter() * self._factor

    def __getattr__(self, name):
        return getattr(self._real, name)


def _worker_main(spec_path, rank):
    import torch.distributed as dist

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    dst.init_distributed(dist_backend="gloo",
                         init_method="file://" + spec["rendezvous"])
    world = dist.get_world_size()
    if rank == spec["slow_rank"]:
        monitor_mod.time = _FastClock(time, SLOW_CLOCK)
    dst.reset_mesh_context()
    model = GPT2Model(GPT2Config(bf16=False, **TINY)).init_params(
        torch.Generator().manual_seed(0))
    eng = dst.initialize(model=model, config=spec["config"], device="cpu")[0]
    mon = eng.monitor
    windows = []
    hook = mon._fleet_window

    def fleet_window(summary):
        extra = hook(summary)
        windows.append(mon.last_fleet_matrix.copy())
        return extra

    mon.stream._window_hook = fleet_window
    rows = len(spec["batches"][0]) // world
    for batch in spec["batches"]:
        loss = eng.forward(torch.from_numpy(
            batch[rank * rows:(rank + 1) * rows]))
        eng.backward(loss)
        eng.step()
    exchanges = mon.fleet.exchanges
    mon.close()
    torch.save({"windows": windows, "exchanges": exchanges,
                "hosts": mon.fleet.host_names(),
                "jsonl": mon.jsonl_path, "out_dir": mon.out_dir},
               os.path.join(spec["out_dir"], f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main(sys.argv[1], int(sys.argv[2]))
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the test side (imports JAX lazily, so that the worker above never does)
# ---------------------------------------------------------------------- #
def _jax():
    import deepspeed_tpu.monitor as jm
    from deepspeed_tpu.config import MonitorConfig as JaxMonitorConfig
    from deepspeed_tpu.monitor import fleet as jfleet
    return jm, jfleet, JaxMonitorConfig


def _summary(t, loss=2.0, gap=0.0, swap_exp=0.0, step=10, gbps=None,
             **extra):
    d = {"last_step": step, "steps": 5, "step_time_mean_s": t,
         "step_time_max_s": t, "loss_mean": loss,
         "host_gap_mean_s": gap, "swap_read_gbps": gbps,
         "swap_exposed_mean_s": swap_exp}
    d.update(extra)
    return d


def _matrix(rows):
    return np.stack([encode_window_vector(r) for r in rows])


class RiggedGather:
    """Injected gather_fn: serves the one-time hostname exchange, then
    the scripted window matrices in order (repeating the last), counting
    the window exchanges."""

    def __init__(self, hosts, matrices):
        self.hosts = hosts
        self.matrices = list(matrices)
        self.window_calls = 0

    def __call__(self, arr):
        arr = np.asarray(arr)
        if arr.dtype == np.uint8:
            return np.stack([_encode_host(h) for h in self.hosts])
        self.window_calls += 1
        return self.matrices[min(self.window_calls - 1,
                                 len(self.matrices) - 1)]


class MockProfiler:
    def __init__(self, fail=False):
        self.fail = fail
        self.started = []
        self.stopped = 0
        self.active = False

    def start_trace(self, path):
        if self.fail:
            raise RuntimeError("no profiler on this host")
        assert not self.active, "start_trace while active"
        self.active = True
        self.started.append(path)

    def stop_trace(self):
        assert self.active, "stop_trace while idle"
        self.active = False
        self.stopped += 1


# ---------------------------------------------------------------------- #
# the window vector and the aggregation records
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("summary", [
    _summary(0.01, loss=2.5, gap=0.001, swap_exp=0.002, step=7, gbps=12.5),
    {"last_step": 3},
    _summary(0.02, grad_norm_mean=1.5, moe_local_load=2.0, bogus="x"),
    {"last_step": "not a number", "loss_mean": None},
], ids=["full", "sparse", "extra_slots", "junk"])
def test_window_vector_codec_matches_jax(summary):
    _, jfleet, _ = _jax()
    vec = encode_window_vector(summary)
    ref = jfleet.encode_window_vector(summary)
    assert vec.shape == (VEC_LEN,) and vec.dtype == np.float64
    np.testing.assert_array_equal(vec, ref)
    assert decode_window_vector(vec) == jfleet.decode_window_vector(ref)
    assert jfleet.VEC_FIELDS == tuple(
        __import__("deepspeed_tpu_torch.monitor.fleet",
                   fromlist=["VEC_FIELDS"]).VEC_FIELDS)


AGG_CASES = {
    "four_hosts": (["h0", "h1", "h2", "h3"],
                   [_summary(0.010), _summary(0.012),
                    _summary(0.020, gbps=4.0), _summary(0.011)]),
    "moe_slots": (["a", "b"], [_summary(0.01, moe_local_load=1.5,
                                        moe_drop_frac=0.1),
                               _summary(0.01, moe_local_load=0.5)]),
    "one_host": (["solo"], [_summary(0.01, step=5)]),
    "nan_host": (["a", "b", "c"], [_summary(0.01), {"last_step": 9},
                                   _summary(0.03, loss=2.2)]),
}


@pytest.mark.parametrize("name", sorted(AGG_CASES))
def test_aggregation_records_match_jax(name):
    _, jfleet, _ = _jax()
    hosts, rows = AGG_CASES[name]
    out_agg = FleetAggregator(0, len(hosts), host=hosts[0],
                              gather_fn=RiggedGather(hosts, [_matrix(rows)]))
    ref_agg = jfleet.FleetAggregator(
        0, len(hosts), host=hosts[0],
        gather_fn=RiggedGather(hosts, [_matrix(rows)]))
    mat, ref_mat = out_agg.exchange(rows[0]), ref_agg.exchange(rows[0])
    np.testing.assert_array_equal(mat, ref_mat)
    assert out_agg.host_names() == hosts
    assert out_agg.per_host_records(mat) == ref_agg.per_host_records(ref_mat)
    fleet = out_agg.fleet_record(mat)
    assert fleet == ref_agg.fleet_record(ref_mat)
    assert summarize_fleet(mat) == jfleet.summarize_fleet(ref_mat)
    assert format_fleet_line(fleet) == jfleet.format_fleet_line(fleet)
    assert out_agg.exchanges == ref_agg.exchanges == 1


def test_single_process_exchange_is_the_local_stack():
    agg = FleetAggregator(process_index=0, process_count=1, host="solo")
    mat = agg.exchange(_summary(0.01, step=5))
    assert mat.shape == (1, VEC_LEN)
    assert agg.fleet_record(mat)[R.FL_HOSTS] == 1
    v = straggler_verdict(mat, agg.host_names())
    assert v["straggler"] is False and v["ratio"] == pytest.approx(1.0)
    with pytest.raises(RuntimeError, match="gather_fn"):
        FleetAggregator(0, 2, host="a").exchange(_summary(0.01))


def test_gather_shape_mismatch_is_loud_in_both():
    _, jfleet, _ = _jax()
    for mod in (sys.modules["deepspeed_tpu_torch.monitor.fleet"], jfleet):
        rig = RiggedGather(["a", "b"], [np.zeros((3, VEC_LEN + 1))])
        agg = mod.FleetAggregator(0, 2, host="a", gather_fn=rig)
        with pytest.raises(ValueError, match="mixed monitor schema"):
            agg.exchange(_summary(0.01))


def test_exchange_deadline_names_the_silent_hosts():
    _, jfleet, _ = _jax()
    out = []
    for mod in (sys.modules["deepspeed_tpu_torch.monitor.fleet"], jfleet):
        def gather(arr):
            if np.asarray(arr).dtype == np.uint8:
                return np.stack([_encode_host(h) for h in ("h0", "h1",
                                                           "h2")])
            time.sleep(1.0)
        agg = mod.FleetAggregator(0, 3, host="h0", gather_fn=gather,
                                  deadline_s=0.05,
                                  arrival_fn=lambda: {1: 0.0, 2: 99.0})
        with pytest.raises(mod.ExchangeTimeout) as err:
            agg.exchange(_summary(0.01))
        out.append((err.value.missing, err.value.missing_hosts(),
                    err.value.as_events(), agg.timeouts))
    assert out[0] == out[1] and out[0][0] == [(2, "h2")]


# ---------------------------------------------------------------------- #
# straggler and divergence detection: scripted windows through both
# ---------------------------------------------------------------------- #
def _warm(hosts, windows=3, t=0.010):
    return [_matrix([_summary(t, step=10 * (w + 1)) for _ in hosts])
            for w in range(windows)]


H4 = ["h0", "h1", "h2", "h3"]
HEALTH_CASES = {
    # (hosts, FleetHealth knobs, the window matrices in order)
    "lane_swap": (H4, dict(warmup_windows=2), _warm(H4) + [_matrix(
        [_summary(0.010, step=40), _summary(0.010, step=40),
         _summary(0.030, gap=0.001, swap_exp=0.018, step=40),
         _summary(0.010, step=40)])]),
    "lane_host_gap": (H4, dict(warmup_windows=2), _warm(H4) + [_matrix(
        [_summary(0.010, step=40)] * 3
        + [_summary(0.025, gap=0.014, step=40)])]),
    "warmup_and_ratio": (["h0", "h1"], dict(warmup_windows=3,
                                            straggler_min_ratio=1.5),
                         [_matrix([_summary(0.010), _summary(0.030)])]
                         + _warm(["h0", "h1"]) + [_matrix(
                             [_summary(0.010, step=40),
                              _summary(0.0125, step=40)])]),
    "persistent_straggler": (H4, dict(warmup_windows=1), _warm(
        H4, windows=2) + [_matrix([_summary(0.010, step=30 + w)] * 3
                                  + [_summary(0.030, step=30 + w)])
                          for w in range(5)]),
    "slow_from_first_window": (H4, dict(warmup_windows=2), [
        _matrix([_summary(0.010, step=10 * (w + 1))] * 3
                + [_summary(0.020, step=10 * (w + 1))]) for w in range(10)]),
    "grad_norm_divergence": (["h0", "h1", "h2"], dict(
        warmup_windows=0, divergence_rel_spread=1e-3), [
        _matrix([_summary(0.01, grad_norm_mean=1.0)] * 2
                + [_summary(0.01, grad_norm_mean=5.0)]),
        _matrix([_summary(0.01, grad_norm_mean=1.0)] * 3)]),
    "loss_divergence": (["h0", "h1", "h2"], dict(
        warmup_windows=0, divergence_rel_spread=1e-3), [
        _matrix([_summary(0.01, loss=2.0)] * 2 + [_summary(0.01,
                                                            loss=2.4)]),
        _matrix([_summary(0.01, loss=2.0)] * 3)]),
    "two_host_straggler": (["h0", "h1"], dict(
        warmup_windows=1, straggler_min_ratio=1.15), _warm(
        ["h0", "h1"], windows=2, t=0.100) + [_matrix(
            [_summary(0.100, step=30), _summary(0.130, step=30)])]),
    "two_host_divergence_ambiguous": (["h0", "h1"], dict(
        warmup_windows=0, divergence_rel_spread=1e-3), [
        _matrix([_summary(0.01, loss=1.0), _summary(0.01, loss=2.0)])]),
    "no_finite_times": (["h0", "h1"], {}, [
        _matrix([{"last_step": 3}, {"last_step": 3}])]),
}


@pytest.mark.parametrize("name", sorted(HEALTH_CASES))
def test_fleet_health_events_match_jax(name):
    jm, _, _ = _jax()
    hosts, knobs, mats = HEALTH_CASES[name]
    out, ref = FleetHealth(**knobs), jm.FleetHealth(**knobs)
    fired = 0
    for mat in mats:
        events = out.observe(mat, hosts)
        assert events == ref.observe(mat, hosts)
        for ev in events:
            assert format_health_line(ev) == jm.format_health_line(ev)
        fired += len(events)
    assert out.counters() == ref.counters()
    expect_quiet = name in ("warmup_and_ratio", "no_finite_times")
    assert (fired == 0) == expect_quiet, fired


@pytest.mark.parametrize("rows,min_ratio", [
    ([_summary(0.010), _summary(0.010), _summary(0.030, swap_exp=0.015)],
     1.15),
    ([_summary(0.010)] * 3, 1.15),
    ([_summary(0.100), _summary(0.130)], 1.15),
    ([_summary(0.010), _summary(0.025, gap=0.014)], 1.15),
    ([_summary(0.010), _summary(0.012)], 1.3),
    ([{"last_step": 1}, {"last_step": 1}], 1.15),
    ([_summary(0.010, moe_local_load=1.0),
      _summary(0.020, moe_local_load=2.0)], 1.15),
], ids=["swap", "healthy", "two_hosts", "host_gap", "under_ratio",
        "no_times", "expert_hotspot"])
def test_straggler_verdict_matches_jax(rows, min_ratio):
    jm, _, _ = _jax()
    mat = _matrix(rows)
    hosts = [f"h{i}" for i in range(len(rows))]
    assert straggler_verdict(mat, hosts, min_ratio=min_ratio) == \
        jm.straggler_verdict(mat, hosts, min_ratio=min_ratio)


@pytest.mark.parametrize("row,median", [
    ({"step_time_mean_s": 0.03, "host_gap_mean_s": 0.001,
      "swap_exposed_mean_s": 0.018}, {"step_time_mean_s": 0.01}),
    ({"step_time_mean_s": 0.025, "host_gap_mean_s": 0.014},
     {"step_time_mean_s": 0.01, "host_gap_mean_s": 0.0}),
    ({"step_time_mean_s": 0.02}, {"step_time_mean_s": 0.01}),
    ({"step_time_mean_s": 0.02, "moe_local_load": 3.0},
     {"step_time_mean_s": 0.01, "moe_local_load": 1.0}),
])
def test_attribute_straggler_lane_matches_jax(row, median):
    jm, _, _ = _jax()
    assert attribute_straggler_lane(row, median) == \
        jm.attribute_straggler_lane(row, median)


# ---------------------------------------------------------------------- #
# the TrainingMonitor over a rigged fleet: both packages' monitors
# ---------------------------------------------------------------------- #
def _rigged_windows(windows=6, slow_from=2, slow_idx=2):
    hosts = [f"host{i}" for i in range(4)]
    mats = []
    for w in range(windows):
        mats.append(_matrix([
            _summary(0.030, gap=0.001, swap_exp=0.018, step=2 * (w + 1))
            if w >= slow_from and p == slow_idx
            else _summary(0.010, step=2 * (w + 1)) for p in range(4)]))
    return hosts, mats


def _fleet_block(path, **extra):
    return dict({"enabled": True, "output_path": str(path),
                 "writers": ["jsonl"], "write_interval": 2, "fleet": True,
                 "health_warmup_windows": 1, "heartbeat": True}, **extra)


@pytest.mark.parametrize("rank", [0, 2])
def test_rigged_fleet_monitor_matches_jax(tmp_path, rank):
    """Six steps of window 2 over the rigged 4-host fleet, host2 3x slow
    from window 3: on rank 0 the per-host, fleet and health records of
    both packages' monitors are equal (the timing fields aside) and no
    capture arms; on rank 2 (the straggler) the health event reaches the
    sentinel sink and arms the capture, which a sentinel-rewound step
    counts toward its K = 2 steps; close() makes no exchange."""
    jm, _, JaxMonitorConfig = _jax()
    results = {}
    for name, cfg_cls, mon_cls in (("port", MonitorConfig, TrainingMonitor),
                                   ("jax", JaxMonitorConfig,
                                    jm.TrainingMonitor)):
        hosts, mats = _rigged_windows()
        rig, prof, sink = RiggedGather(hosts, mats), MockProfiler(), []
        mon = mon_cls(
            cfg_cls.from_dict(_fleet_block(
                tmp_path / name, capture={"enabled": True, "steps": 2,
                                          "max_captures": 1})),
            process_index=rank, world_size=4, host=hosts[rank],
            gather_fn=rig, profiler=prof, health_sink=sink.append)
        armed_at = None
        for step in range(1, 7):
            mon.mark_step_start()
            mon.end_step(step, loss=2.0)
            if armed_at is None and mon.capture.armed:
                armed_at = step
        if rank == 2:
            mon.mark_step_start()
            mon.discard_step()
            assert mon.capture.armed
            mon.mark_step_start()
            mon.end_step(7, loss=2.0)
        mon.close()
        recs = ([json.loads(line) for line in open(mon.jsonl_path)]
                if mon.jsonl_path else [])
        results[name] = dict(
            calls=rig.window_calls, started=len(prof.started),
            stopped=prof.stopped, armed_at=armed_at,
            capture=mon.capture.counters(), sink=sink,
            health=[e for e in mon.last_health_events],
            kinds=[r["kind"] for r in recs],
            fleet=[r for r in recs if r["kind"] in (R.KIND_FLEET_HOST,
                                                    R.KIND_FLEET,
                                                    R.KIND_HEALTH)],
            beats=[b["status"] for b in read_heartbeats(
                os.path.join(mon.out_dir, "heartbeat"))])
    out, ref = results["port"], results["jax"]
    assert out == ref
    assert out["calls"] == 3  # full windows only, none at close()
    if rank == 0:
        assert out["kinds"].count(R.KIND_FLEET) == 3
        assert out["kinds"].count(R.KIND_FLEET_HOST) == 12
        assert [e[R.F_HOST] for e in out["fleet"]
                if e["kind"] == R.KIND_HEALTH] == ["host2"]
        assert out["started"] == 0 and out["sink"][0][R.F_HOST] == "host2"
    else:
        assert out["kinds"] == [] and out["armed_at"] == 6
        assert out["started"] == out["stopped"] == 1
        assert [e[R.H_EVENT] for e in out["sink"]] == [R.EVENT_STRAGGLER]
        assert out["sink"][0][R.H_LANE] == "io-bound (swap exposed)"
    assert out["beats"] == ["stopped"]


def test_fleet_exchange_failure_disables_the_hook_loudly(tmp_path):
    """A failed exchange disables the fleet hook (a broken collective is
    never re-entered), records the degradation and marks it in the
    stream; the steps' records still land."""
    from deepspeed_tpu_torch.runtime.resilience import degradation
    degradation.get_registry().clear()

    def broken(arr):
        if np.asarray(arr).dtype == np.uint8:
            return np.stack([_encode_host(h) for h in ("h0", "h1")])
        raise RuntimeError("gloo peer went away")

    mon = TrainingMonitor(MonitorConfig.from_dict(_fleet_block(tmp_path)),
                          process_index=0, world_size=2, host="h0",
                          gather_fn=broken,
                          extra_records_fn=degradation.get_registry()
                          .drain_records)
    for step in range(1, 7):
        mon.mark_step_start()
        mon.end_step(step, loss=1.0)
    mon.close()
    recs = [json.loads(line) for line in open(mon.jsonl_path)]
    assert [r[R.F_STEP] for r in recs if r["kind"] == R.KIND_STEP] == \
        list(range(1, 7))
    assert any(r["kind"] == R.KIND_META and "gloo peer" in
               r.get("fleet_disabled", "") for r in recs)
    assert ("fleet_monitor", "aggregating", "disabled") in [
        (e["subsystem"], e["from_tier"], e["to_tier"])
        for e in degradation.get_registry().events()]
    assert not mon.stream.fleet_live
    degradation.get_registry().clear()


# ---------------------------------------------------------------------- #
# the profiler capture
# ---------------------------------------------------------------------- #
def _capture_script(cap):
    """The arm / observe / rate-limit sequence of the JAX package's
    test_capture_arm_disarm_and_rate_limit; every return and state."""
    log = [cap.arm("step_time_above_band", step=5), cap.armed,
           cap.arm("again", step=5)]
    for s in (6, 7, 8):
        cap.observe_step_end(s)
        log.append(cap.armed)
    log += [cap.captures[0]["steps"], cap.arm("too-soon", step=12),
            cap.arm("ok", step=18)]
    cap.observe_step_end(19)
    cap.close(20)
    log += [cap.armed, cap.arm("third", step=100), cap.counters(),
            cap.maybe_arm_for_flags(["model_violation"], 200)]
    return log


def test_capture_state_machine_matches_jax(tmp_path):
    jm, _, _ = _jax()
    out_prof, ref_prof = MockProfiler(), MockProfiler()
    out = _capture_script(ProfileCapture(
        str(tmp_path / "port"), steps=3, max_captures=2, cooldown_steps=10,
        profiler=out_prof))
    ref = _capture_script(jm.ProfileCapture(
        str(tmp_path / "jax"), steps=3, max_captures=2, cooldown_steps=10,
        profiler=ref_prof))
    assert out == ref
    assert out_prof.stopped == ref_prof.stopped == 2
    assert [os.path.basename(p) for p in out_prof.started] == [
        "capture0_step5_step_time_above_band.json", "capture1_step18_ok.json"]


def test_capture_trigger_flags_and_a_failed_start(tmp_path):
    from deepspeed_tpu_torch.runtime.resilience import degradation
    jm, _, _ = _jax()
    degradation.get_registry().clear()
    for mod in (sys.modules["deepspeed_tpu_torch.monitor.capture"], jm):
        prof = MockProfiler()
        cap = mod.ProfileCapture(str(tmp_path), steps=1, profiler=prof)
        assert cap.maybe_arm_for_flags(["model_violation"], 1) is False
        assert cap.maybe_arm_for_flags(["swap_below_ceiling_band"], 1)
        cap.observe_step_end(2)
        assert prof.stopped == 1
        bad = mod.ProfileCapture(str(tmp_path / "bad"),
                                 profiler=MockProfiler(fail=True))
        assert bad.arm("x", 1) is False and bad.exhausted
        assert bad.arm("y", 500) is False
    port_bad = ProfileCapture(str(tmp_path / "bad2"),
                              profiler=MockProfiler(fail=True))
    assert port_bad.arm("x", 1) is False and port_bad.failures == 1
    assert ("profiling", "torch-profiler", "off") in [
        (e["subsystem"], e["from_tier"], e["to_tier"])
        for e in degradation.get_registry().events()]
    degradation.get_registry().clear()


def test_a_real_torch_profiler_capture_on_the_cpu(tmp_path):
    """The default profiler: K = 2 steps of CPU work, then the Chrome
    trace, which parses and holds the steps' operators."""
    cap = ProfileCapture(str(tmp_path / "profiles"), steps=2)
    assert cap.arm("chip-check", step=3)
    x = torch.randn(64, 64)
    for step in (4, 5):
        (x @ x).sum()
        cap.observe_step_end(step)
    assert not cap.armed and cap.captures[0]["steps"] == 2
    path = cap.captures[0]["path"]
    assert path.endswith("capture0_step3_chip-check.json")
    payload = json.load(open(path))
    names = {ev.get("name") for ev in payload["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names


# ---------------------------------------------------------------------- #
# heartbeats: each package reads the other's files
# ---------------------------------------------------------------------- #
def test_heartbeat_files_read_across_packages(tmp_path):
    jm, _, _ = _jax()
    from deepspeed_tpu.monitor import heartbeat as jhb
    d = str(tmp_path / "hb")
    for p in range(3):
        writer = (HeartbeatWriter if p % 2 == 0 else jm.HeartbeatWriter)
        writer(d, process_index=p, world_size=3, host=f"host{p}").beat(
            step=40 + p)
    now = time.time()
    for later, stale_after in ((0, 60), (120, 60), (120, 1e9)):
        out = annotate_stale(read_heartbeats(d, now=now + later),
                             stale_after)
        ref = jm.annotate_stale(jm.read_heartbeats(d, now=now + later),
                                stale_after)
        assert out == ref
        assert format_watch_table(read_heartbeats(d, now=now + later),
                                  stale_after, expected_procs=4) == \
            jm.format_watch_table(jm.read_heartbeats(d, now=now + later),
                                  stale_after, expected_procs=4)
    assert [b["step"] for b in read_heartbeats(d)] == [40, 41, 42]
    assert "MISSING" in format_watch_table(read_heartbeats(d),
                                           expected_procs=4)
    assert "STALE" in format_watch_table(read_heartbeats(d, now=now + 120),
                                         stale_after_s=60)
    # a stopped host is never stale, and a long beat interval stretches
    # the threshold
    HeartbeatWriter(d, 1, 3, host="host1").close(step=43)
    beats = annotate_stale(read_heartbeats(d, now=now + 120), 60)
    assert beats[1]["status"] == "stopped" and not beats[1]["stale"]
    slow = [{"host": "big", "process_index": 0, "status": "running",
             "age_s": 150.0, "interval_s": 100.0}]
    assert annotate_stale(slow, 60)[0]["stale"] is False
    assert jhb.STALE_AFTER_S_DEFAULT == 60.0


def test_heartbeat_corrupt_file_and_dir_resolution(tmp_path):
    jm, _, _ = _jax()
    from deepspeed_tpu.monitor.heartbeat import (
        resolve_heartbeat_dir as jax_resolve)
    d = str(tmp_path / "hb")
    HeartbeatWriter(d, 0, 1, host="ok").beat(step=1)
    with open(os.path.join(d, "hb_9.json"), "w") as f:
        f.write("{torn")
    beats = read_heartbeats(d)
    corrupt = [b for b in beats if b["status"] == "corrupt"]
    assert len(corrupt) == 1 and corrupt[0]["process_index"] == 9
    now = time.time()
    assert format_watch_table(read_heartbeats(d, now=now),
                              expected_procs=10) == \
        jm.format_watch_table(jm.read_heartbeats(d, now=now),
                              expected_procs=10)
    root = str(tmp_path / "out")
    assert resolve_heartbeat_dir(root) == jax_resolve(root)
    HeartbeatWriter(os.path.join(root, "run1", "heartbeat"), 0, 2,
                    host="w0").beat(step=3)
    assert resolve_heartbeat_dir(root) == jax_resolve(root) == \
        os.path.join(root, "run1", "heartbeat")
    HeartbeatWriter(os.path.join(root, "heartbeat"), 0, 2,
                    host="w0").beat(step=3)
    assert resolve_heartbeat_dir(root) == jax_resolve(root) == \
        os.path.join(root, "heartbeat")


# ---------------------------------------------------------------------- #
# two gloo processes, one slow
# ---------------------------------------------------------------------- #
def test_two_gloo_processes_name_the_slow_rank(tmp_path):
    """Two processes train the tiny GPT-2 (ZeRO-2, 8 steps) under
    monitor.fleet with window 2, no health warm-up, and heartbeats; rank
    1's monitor measures on a clock that runs 5x.  Every rank exchanges
    once a full window (4), over the gloo group the engine made, and
    receives the same matrices; rank 0's stream holds a fleet_host record
    a rank and a fleet record a window, and straggler health records
    naming rank 1; both ranks beat.  The JAX aggregator and detector, fed the same
    window matrices, give the same records and events."""
    jm, jfleet, _ = _jax()
    world, slow = 2, 1
    batches = [np.random.default_rng(5 + k).integers(
        0, TINY["vocab_size"], (8, 16)).astype(np.int64)
        for k in range(E2E_STEPS)]
    config = {"train_micro_batch_size_per_gpu": 8 // world,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "zero_optimization": {"stage": 2},
              "steps_per_print": 10 ** 9,
              "monitor": _fleet_block(tmp_path / "mon",
                                      write_interval=E2E_WINDOW,
                                      health_warmup_windows=0,
                                      writers=["jsonl", "csv"])}
    spec = os.path.join(str(tmp_path), "spec.pt")
    torch.save({"rendezvous": os.path.join(str(tmp_path), "rdv"),
                "out_dir": str(tmp_path), "slow_rank": slow,
                "config": config, "batches": batches}, spec)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DS_", "OMPI_"))
           and k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                         "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(MASTER_ADDR="localhost", MASTER_PORT="29500",
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        logs.append(open(os.path.join(str(tmp_path), f"rank{rank}.log"),
                         "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, str(rank)],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=logs[-1], stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        for proc in procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        with open(os.path.join(str(tmp_path), f"rank{bad[0]}.log")) as f:
            pytest.fail(f"worker {bad[0]} failed:\n{f.read()[-3000:]}")
    res = [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"),
                      weights_only=False) for r in range(world)]
    windows = E2E_STEPS // E2E_WINDOW
    assert [r["exchanges"] for r in res] == [windows] * world
    for r in res:
        assert len(r["windows"]) == windows
        for a, b in zip(r["windows"], res[0]["windows"]):
            np.testing.assert_array_equal(a, b)  # every rank, one matrix
    recs = [json.loads(line) for line in open(res[0]["jsonl"])]
    kinds = [r["kind"] for r in recs]
    assert kinds.count(R.KIND_STEP) == E2E_STEPS
    assert kinds.count(R.KIND_FLEET) == windows
    assert kinds.count(R.KIND_FLEET_HOST) == windows * world
    # every window's matrix shows rank 1 at ~SLOW_CLOCK x rank 0 (the
    # processes step in lockstep), and the EWMA detector, whose baseline
    # follows the host's timing noise, names rank 1 from the second window
    # on (at least there, where its baseline is the first window's)
    for mat in res[0]["windows"]:
        times = mat[:, jfleet._IDX["step_time_mean_s"]]
        assert times[slow] / times[0] > 0.5 * SLOW_CLOCK
    health = [r for r in recs if r["kind"] == R.KIND_HEALTH]
    assert health and all(
        (h[R.H_EVENT], h[R.F_PROCESS_INDEX]) == (R.EVENT_STRAGGLER, slow)
        and h[R.H_RATIO] > 0.5 * SLOW_CLOCK for h in health), health
    # the JAX fleet layer over the same matrices
    hosts = res[0]["hosts"]
    agg = jfleet.FleetAggregator(0, world, host=hosts[0],
                                 gather_fn=RiggedGather(hosts,
                                                        res[0]["windows"]))
    det = jm.FleetHealth(warmup_windows=0)
    ref = []
    for w in range(windows):
        mat = agg.exchange({})
        ref.extend(agg.per_host_records(mat))
        ref.append({k: v for k, v in agg.fleet_record(mat).items()})
        ref.extend(det.observe(mat, hosts))
    got = [{k: v for k, v in r.items() if k != R.FL_WINDOW_START}
           for r in recs if r["kind"] in (R.KIND_FLEET_HOST, R.KIND_FLEET,
                                          R.KIND_HEALTH)]
    assert got == ref
    # every rank beat, and stopped
    beats = read_heartbeats(os.path.join(res[0]["out_dir"], "heartbeat"))
    assert [(b["process_index"], b["status"], b["step"]) for b in beats] \
        == [(0, "stopped", E2E_STEPS), (1, "stopped", E2E_STEPS)]
