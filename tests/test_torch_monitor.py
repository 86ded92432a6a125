"""The port's runtime monitor (deepspeed_tpu_torch/monitor/ and the
engine's `monitor` / `tensorboard` blocks) on the CPU, held against the
JAX package's (deepspeed_tpu/monitor/, the JAX engine's hooks) on the
same inputs: the step-record schema, the reconciliation math (every case
of tests/unit/test_monitor.py), the trace buffer and its validator, the
JSONL / CSV writers, the degradation registry's summary and drain, the
tensorboard fallback chain, and 8 steps of the tiny GPT-2 of
tests/test_torch_training.py through both engines under one monitor
config (modular at gas 1 and 2, fused at gas 2): the record kinds in
order, the step records' keys and fields, the losses, the trace's lanes
and phases per step.  The JAX engine runs on the conftest's 8-device CPU
mesh at micro-batch 1, the port at one rank and micro-batch 8 (the same
global batch); both take the measured-only reconciliation (the JAX
engine's auditor is made to fail here: the port has none).  Also: the
monitor's per-step calls read nothing from the device."""

import csv
import json
import os
import sys
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import deepspeed_tpu.analysis as jax_analysis
from deepspeed_tpu.monitor import monitor as jax_monitor_mod
from deepspeed_tpu.monitor import record as jax_record
from deepspeed_tpu.monitor import reconcile as jax_reconcile
from deepspeed_tpu.monitor import trace as jax_trace
from deepspeed_tpu.monitor import writers as jax_writers
from deepspeed_tpu.runtime.resilience import degradation as jax_degradation
from deepspeed_tpu_torch.monitor import monitor as monitor_mod
from deepspeed_tpu_torch.monitor import record as R
from deepspeed_tpu_torch.monitor import reconcile
from deepspeed_tpu_torch.monitor import trace
from deepspeed_tpu_torch.monitor import writers
from deepspeed_tpu_torch.runtime.resilience import degradation

from .test_torch_checkpoint import (_conf, _fresh_registries,  # noqa: F401
                                    _jax_engine, _port_engine)
from .test_torch_training import _ids, _jax_params

# the losses' tolerance of test_engine_trajectory_matches_jax (fp32)
LOSS_RTOL = 1e-4
STEPS = 8


@pytest.fixture(autouse=True)
def _fresh_degradations():
    """Both packages' registries are process-global: start each test from
    empty ones, so that a record's first report reaches the stream."""
    degradation.get_registry().clear()
    jax_degradation.get_registry().clear()
    yield
    degradation.get_registry().clear()
    jax_degradation.get_registry().clear()


# ---------------------------------------------------------------------- #
# the record schema
# ---------------------------------------------------------------------- #
def test_schema_names_are_the_jax_packages():
    assert R.SCHEMA_VERSION == jax_record.SCHEMA_VERSION
    assert R.STEP_RECORD_FIELDS == jax_record.STEP_RECORD_FIELDS
    names = {k: v for k, v in vars(jax_record).items()
             if k.isupper() and isinstance(v, (str, int, tuple))}
    assert names == {k: v for k, v in vars(R).items()
                     if k.isupper() and isinstance(v, (str, int, tuple))}


@pytest.mark.parametrize("case", [
    dict(step=3, loss=2.5, wall_s=0.125, tokens=4096,
         counters={"skipped_steps": 1, "dispatches_per_step": 2,
                   "io_retries": 0},
         boundary={"lr": 6e-4, "loss_scale": 1.0},
         memory={"mem_peak_bytes": 10, "mem_in_use_bytes": 5,
                 "mem_source": "device"},
         host_gap_s=0.0012345678),
    dict(step=1, loss=None, wall_s=None, tokens=None, counters={},
         boundary={}, memory={"mem_peak_bytes": None,
                              "mem_in_use_bytes": None,
                              "mem_source": "unavailable"}),
    dict(step=7, loss=1.0, wall_s=0.5, tokens=100, counters={},
         boundary={"lr": 1.0}, memory={},
         swap={"read_gbps": 3.5, "overlap_fraction": 0.5,
               "read_vs_ceiling": 0.2}, extra={"custom": 1}),
], ids=["full", "empty", "swap_extra"])
def test_make_step_record_matches_jax(case):
    assert R.make_step_record(**case) == jax_record.make_step_record(**case)


def test_identity_and_memory_on_the_cpu():
    ident = R.identity()
    assert ident[R.F_PROCESS_INDEX] == 0 and ident[R.F_WORLD_SIZE] == 1
    assert ident == jax_record.identity()
    assert R.identity(3, 4, "h") == jax_record.identity(3, 4, "h")
    mem = R.device_memory(torch.device("cpu"))
    assert mem[R.F_MEM_SOURCE] == "host_rss" and mem[R.F_MEM_PEAK_BYTES] > 0


def test_batched_loss_fetch_one_transfer_keeps_none_and_numbers():
    refs = [torch.tensor(1.23456789), None, torch.tensor(2.0,
                                                        dtype=torch.bfloat16),
            0.5, torch.tensor([3.25], dtype=torch.float64)]
    assert monitor_mod._batched_loss_fetch(refs) == [
        round(1.23456789, 6), None, 2.0, 0.5, 3.25]
    assert monitor_mod._batched_loss_fetch([]) == []
    assert monitor_mod._batched_loss_fetch([None]) == [None]


# ---------------------------------------------------------------------- #
# reconciliation (tests/unit/test_monitor.py's test_reconcile_* cases)
# ---------------------------------------------------------------------- #
def _pred(lb=0.010, compute=0.010, memory=0.002, hidden=0.001,
          exposed=0.0, hbm=None):
    return {"predicted_step_time_lb_s": lb,
            "lanes": {"compute": compute, "memory": memory,
                      "hidden_comm": hidden, "exposed_comm": exposed},
            "peak_hbm_bytes": hbm}


_SWAP = {"read_gbps": 1.0, "sweep_read_gbps": 20.0,
         "read_vs_ceiling": 0.05, "overlap_fraction": 0.8}
RECONCILE_CASES = {
    "within_band": ({"step_time_s": 0.03}, _pred(), {}),
    "above_band": ({"step_time_s": 0.5},
                   _pred(lb=0.01, compute=0.002, memory=0.010, hidden=0.0),
                   {"step_time_ratio_max": 10.0}),
    "model_violation": ({"step_time_s": 0.005}, _pred(lb=0.010), {}),
    "hbm_over": ({"step_time_s": None, "hbm_peak_bytes": 300,
                  "mem_source": "device"}, _pred(hbm=100),
                 {"hbm_ratio_max": 2.0}),
    "hbm_under": ({"step_time_s": None, "hbm_peak_bytes": 40,
                   "mem_source": "device"}, _pred(hbm=100),
                  {"hbm_ratio_max": 2.0}),
    "hbm_host_rss": ({"step_time_s": None, "hbm_peak_bytes": 300,
                      "mem_source": "host_rss"}, _pred(hbm=100),
                     {"hbm_ratio_max": 2.0}),
    "swap_below_ceiling": ({"step_time_s": None, "swap": _SWAP}, None,
                           {"swap_min_vs_ceiling": 0.25}),
    "swap_ok": ({"step_time_s": None,
                 "swap": dict(_SWAP, read_vs_ceiling=0.6)}, None,
                {"swap_min_vs_ceiling": 0.25}),
    "no_predictions": ({"step_time_s": 0.1}, None, {}),
    "swap_exposed_wins": ({"step_time_s": 0.1,
                           "swap": {"read_exposed_s": 0.08}},
                          _pred(lb=0.01, compute=0.010, memory=0.001,
                                hidden=0.0), {}),
    "measured_window": ({"window_start_step": 11, "window_end_step": 20,
                         "step_time_s": 0.29, "hbm_peak_bytes": 17 << 30,
                         "mem_source": "device", "swap": None}, None, {}),
}


@pytest.mark.parametrize("name", sorted(RECONCILE_CASES))
def test_reconcile_window_matches_jax(name):
    measured, predicted, bands = RECONCILE_CASES[name]
    out = reconcile.reconcile_window(measured, predicted,
                                     reconcile.Bands(**bands))
    ref = jax_reconcile.reconcile_window(measured, predicted,
                                         jax_reconcile.Bands(**bands))
    assert out == ref
    assert reconcile.format_line(out) == jax_reconcile.format_line(ref)
    assert reconcile.bare_summary(out) == jax_reconcile.bare_summary(ref)


@pytest.mark.parametrize("lanes,swap,measured", [
    ({"compute": 0.002, "memory": 0.001, "hidden_comm": 0.0,
      "exposed_comm": 0.008}, None, None),
    ({"compute": 0.010, "memory": 0.001, "hidden_comm": 0.0,
      "exposed_comm": 0.0}, {"read_exposed_s": 0.08, "write_exposed_s": 0.0},
     0.1),
    ({"compute": 0.010, "memory": 0.001, "hidden_comm": 0.0,
      "exposed_comm": 0.0}, {"read_exposed_s": 0.01}, 0.1),
    ({"compute": 0.001, "memory": 0.0, "hidden_comm": 0.003,
      "swap": 0.004}, None, None),
    ({}, None, None),
])
def test_attribute_gap_matches_jax(lanes, swap, measured):
    assert reconcile.attribute_gap(lanes, swap, measured) == \
        jax_reconcile.attribute_gap(lanes, swap, measured)


# ---------------------------------------------------------------------- #
# the trace buffer and its validator
# ---------------------------------------------------------------------- #
def _fill(buf):
    t = 100.0
    buf.add_span("grad_dispatch", t, t + 0.002, step=1)
    buf.add_span("accumulate_dispatch", t + 0.002, t + 0.003, step=1)
    buf.add_span("apply_dispatch", t + 0.003, t + 0.004, step=1,
                 args={"x": 1})
    buf.add_instant("flush", t + 0.005, args={"records": 3})
    buf.add_counter("moe routing", t + 0.006,
                    {"drop_fraction": 0.1, "imbalance": None})
    buf.add_swap_read_events([{"name": "g0", "t_issue": t, "t_done": t + 0.01,
                               "bytes": 64, "hidden_s": 0.004,
                               "exposed_s": 0.006}], step=2)
    buf.add_swap_write_events([{"name": "w0", "t_issue": t,
                                "t_done": t + 0.02, "bytes": 8,
                                "wait_s": 0.001}], step=3)
    buf.add_span("fused_step(gas=4)", t + 0.01, t + 0.02, step=4)
    buf.note_untraced_step(5)
    return buf.to_json()


def test_trace_buffer_events_match_jax():
    out = _fill(trace.TraceEventBuffer(max_steps=3))
    ref = _fill(jax_trace.TraceEventBuffer(max_steps=3))
    assert out["traceEvents"] == ref["traceEvents"]
    for key in ("schema_version", "steps_traced", "truncated_at_max_steps"):
        assert out["otherData"][key] == ref["otherData"][key]
    assert out["otherData"]["truncated_at_max_steps"] is True
    assert set(out["otherData"]["phases"]) == {
        "grad_dispatch", "accumulate_dispatch", "apply_dispatch",
        "fused_step(gas=N)"}
    assert trace.validate_trace_events(out) == []


@pytest.mark.parametrize("payload", [
    {"traceEvents": "nope"},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1,
                      "ts": 0.0}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1,
                      "ts": -1.0, "dur": -2.0}]},
    {"traceEvents": [{"ph": "Q", "tid": 1}]},
    {"traceEvents": [{"name": "i", "ph": "i", "pid": 1, "tid": 4,
                      "ts": "late"}]},
    {"traceEvents": [], "otherData": {"schema_version": 99}},
    {"traceEvents": [], "otherData": {"schema_version": "2"}},
    {"traceEvents": [{"name": "ok", "ph": "X", "pid": 1, "tid": 1,
                      "ts": 1.0, "dur": 2.0}],
     "otherData": {"schema_version": 2}},
], ids=["not_a_list", "x_without_dur", "negative", "unknown_ph",
        "instant_ts", "future_schema", "schema_not_int", "good"])
def test_trace_validator_matches_jax(payload):
    assert trace.validate_trace_events(payload) == \
        jax_trace.validate_trace_events(payload)


# ---------------------------------------------------------------------- #
# the writers
# ---------------------------------------------------------------------- #
def _records():
    recs = []
    for step in (1, 2, 3):
        rec = R.make_step_record(
            step, 2.0 / step, 0.01 * step, 1024,
            {R.F_SKIPPED_STEPS: 0, R.F_DISPATCHES_PER_STEP: 2},
            {"lr": 1e-3, "loss_scale": 1.0},
            {R.F_MEM_PEAK_BYTES: 123, R.F_MEM_IN_USE_BYTES: None,
             R.F_MEM_SOURCE: "host_rss"}, host_gap_s=1e-4)
        rec.update(R.identity(0, 1, "h"), extra_field=np.float32(0.5))
        recs.append(rec)
    recs.append({R.F_KIND: R.KIND_RECONCILE, "flags": [],
                 "vec": np.arange(3)})
    return recs


def test_jsonl_and_csv_writers_match_jax_byte_for_byte(tmp_path):
    files = {}
    for name, mod in (("port", writers), ("jax", jax_writers)):
        jl = str(tmp_path / name / "metrics.jsonl")
        cs = str(tmp_path / name / "metrics.csv")
        thread = mod.WriterThread([mod.JsonlWriter(jl), mod.CsvWriter(cs)])
        recs = _records()
        thread.submit(recs[:2])
        thread.submit(recs[2:])
        thread.close()
        thread.close()  # idempotent
        files[name] = (open(jl).read(), open(cs).read())
    assert files["port"] == files["jax"]
    jl_text, csv_text = files["port"]
    lines = [json.loads(line) for line in jl_text.splitlines()]
    assert [r[R.F_KIND] for r in lines] == ["step"] * 3 + ["reconcile"]
    assert lines[0]["extra_field"] == 0.5 and lines[3]["vec"] == [0, 1, 2]
    rows = list(csv.reader(csv_text.splitlines()))
    assert tuple(rows[0]) == R.STEP_RECORD_FIELDS and len(rows) == 4


def test_tensorboard_writer_adapter_matches_jax():
    class Sink:
        def __init__(self):
            self.calls = []

        def add_scalar(self, tag, value, step):
            self.calls.append((tag, value, step))

        def flush(self):
            pass

    out, ref = Sink(), Sink()
    for rec in _records():
        writers.TensorBoardWriter(out).write(rec)
        jax_writers.TensorBoardWriter(ref).write(rec)
    assert out.calls == ref.calls and out.calls


# ---------------------------------------------------------------------- #
# the degradation registry
# ---------------------------------------------------------------------- #
def test_degradation_summary_and_drain_match_jax():
    regs = (degradation.DegradationRegistry(),
            jax_degradation.DegradationRegistry())
    seen = [[], []]
    for i, reg in enumerate(regs):
        assert reg.summary() == "" and reg.drain_records() == []
        reg.record("tensorboard", "torch", "jsonl", "no backend")
        reg.record("monitor-predictions", "static-audit", "measured-only")
        reg.record("tensorboard", "torch", "jsonl", "again")  # a repeat
        seen[i].append(reg.summary())
        seen[i].append(reg.drain_records())
        seen[i].append(reg.drain_records())
        reg.record("checkpoint", "atomic", "in_place", "process group")
        seen[i].append(reg.drain_records())
        seen[i].append(reg.events())
        reg.clear()
        seen[i].append((reg.summary(), reg.drain_records()))
    assert seen[0] == seen[1]
    assert seen[0][0] == ("tensorboard:torch->jsonl, "
                          "monitor-predictions:static-audit->measured-only")
    assert [r["subsystem"] for r in seen[0][1]] == ["tensorboard",
                                                    "monitor-predictions"]
    assert seen[0][1][0]["kind"] == R.KIND_DEGRADATION
    assert seen[0][2] == [] and len(seen[0][3]) == 1


# ---------------------------------------------------------------------- #
# the engines under one monitor config
# ---------------------------------------------------------------------- #
def _monitor_block(path, **extra):
    return dict({"enabled": True, "output_path": str(path),
                 "writers": ["jsonl", "csv"], "trace": True,
                 "trace_steps": 6, "write_interval": 3, "fleet": True,
                 "heartbeat": True}, **extra)


def _drive(eng, batches, fused, gas, to_device):
    """STEPS optimizer steps; each step's loss as the engine returned it."""
    it = iter([(to_device(b),) for b in batches])
    out = []
    for _ in range(STEPS):
        if fused:
            out.append(float(eng.train_batch(it)))
            continue
        for _ in range(gas):
            (b,) = next(it)
            loss = eng.forward(b)
            eng.backward(loss)
            eng.step()
        out.append(float(loss.detach() if isinstance(loss, torch.Tensor)
                         else loss))
    eng.monitor.close()
    return out


def _phases_by_step(path):
    payload = json.load(open(path))
    assert trace.validate_trace_events(payload) == []
    assert jax_trace.validate_trace_events(payload) == []
    steps = {}
    for ev in payload["traceEvents"]:
        if ev["ph"] == "X":
            steps.setdefault(ev["args"]["step"], []).append(
                (ev["tid"], ev["name"]))
    lanes = sorted((ev["tid"], ev["args"]["name"])
                   for ev in payload["traceEvents"] if ev["ph"] == "M")
    flushes = sum(1 for ev in payload["traceEvents"]
                  if ev["ph"] == "i" and ev["name"] == "flush")
    return steps, lanes, flushes, payload["otherData"]


@pytest.mark.parametrize("fused,gas", [(False, 1), (False, 2), (True, 2)],
                         ids=["modular_gas1", "modular_gas2", "fused_gas2"])
def test_engine_records_and_trace_match_the_jax_engine(tmp_path, monkeypatch,
                                                       fused, gas):
    def no_auditor(*args, **kwargs):
        raise RuntimeError("no auditor in this comparison")

    monkeypatch.setattr(jax_analysis, "audit_engine", no_auditor)
    _, tree = _jax_params(False)
    batches = [_ids(8, 16, seed=70 + k) for k in range(STEPS * gas)]
    extra = dict(gradient_accumulation_steps=gas,
                 fused_step={"enabled": fused})
    jeng = _jax_engine(tree, _conf(1, monitor=_monitor_block(
        tmp_path / "jax"), **extra))
    assert (jeng._fused_step_fn is not None) == fused
    ref = _drive(jeng, batches, fused, gas, jnp.asarray)
    eng = _port_engine(tree, _conf(8, monitor=_monitor_block(
        tmp_path / "port"), **extra))
    assert (eng._fused is not None) == fused
    out = _drive(eng, batches, fused, gas, torch.from_numpy)
    np.testing.assert_allclose(out, ref, rtol=LOSS_RTOL)

    def stream(mon):
        return [json.loads(line) for line in open(mon.jsonl_path)]

    got, want = stream(eng.monitor), stream(jeng.monitor)
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    assert [r["kind"] for r in got].count("step") == STEPS
    # the one degradation: measured-only reconciliation, in both
    deg = [[(r["subsystem"], r["from_tier"], r["to_tier"]) for r in recs
            if r["kind"] == R.KIND_DEGRADATION] for recs in (got, want)]
    assert deg[0] == deg[1] == [("monitor-predictions", "static-audit",
                                 "measured-only")]
    steps = [[r for r in recs if r["kind"] == R.KIND_STEP]
             for recs in (got, want)]
    for o, r in zip(*steps):
        assert set(o) == set(r)
        for key in ("step", "dispatches_per_step", "skipped_steps", "lr",
                    "loss_scale", "mem_source", "host", "process_index",
                    "world_size", "sentinel_anomalies", "retraces",
                    "io_retries"):
            assert o[key] == r[key], key
        # tokens a step: the global batch's (tokens/s is over it)
        assert o["wall_time_s"] > 0 and o["tokens_per_sec"] > 0
        assert (o["tokens_per_sec"] * o["wall_time_s"]
                == pytest.approx(8 * gas * 16, rel=1e-3))
    assert [o["step"] for o in steps[0]] == list(range(1, STEPS + 1))
    assert [o["dispatches_per_step"] for o in steps[0]] == \
        [1 if fused else 2 * gas] * STEPS
    np.testing.assert_allclose([o["loss"] for o in steps[0]],
                               [r["loss"] for r in steps[1]], rtol=LOSS_RTOL)
    # each record's loss is the engine's returned loss, rounded
    assert [o["loss"] for o in steps[0]] == [round(v, 6) for v in out]
    recon = [[r for r in recs if r["kind"] == R.KIND_RECONCILE]
             for recs in (got, want)]
    for o, r in zip(*recon):
        assert set(o) == set(r)
        assert (o["window_start_step"], o["window_end_step"]) == \
            (r["window_start_step"], r["window_end_step"])
        assert o["flags"] == r["flags"] == []
        assert o["predicted_step_time_lb_s"] is None
    fleet = [[r for r in recs if r["kind"] == R.KIND_FLEET]
             for recs in (got, want)]
    for o, r in zip(*fleet):
        assert set(o) == set(r) and o["hosts"] == r["hosts"] == 1
    meta = [recs[0] for recs in (got, want)]
    for key in ("schema_version", "zero_stage", "gas", "fused_step",
                "dtype", "engine"):
        assert meta[0][key] == meta[1][key], key
    # the trace: the same lanes, and the same phases for every step
    t_out, t_ref = (_phases_by_step(m.trace_path)
                    for m in (eng.monitor, jeng.monitor))
    assert t_out[0] == t_ref[0] and t_out[1] == t_ref[1]
    # the flush instants before the trace saturated at its 6 steps
    assert t_out[2] == t_ref[2] == 1
    for key in ("steps_traced", "truncated_at_max_steps", "schema_version"):
        assert t_out[3][key] == t_ref[3][key]
    expect = ([f"fused_step(gas={gas})"] if fused else
              ["grad_dispatch", "accumulate_dispatch"] * gas
              + ["apply_dispatch"])
    assert [name for _, name in t_out[0][1]] == expect
    # the CSV: the step records in the schema's columns
    rows = list(csv.reader(open(eng.monitor.csv_path)))
    assert tuple(rows[0]) == R.STEP_RECORD_FIELDS and len(rows) == STEPS + 1
    # one heartbeat a process, stopped at the last step
    beats = [json.load(open(os.path.join(m.out_dir, "heartbeat",
                                         "hb_0.json")))
             for m in (eng.monitor, jeng.monitor)]
    assert [b["status"] for b in beats] == ["stopped"] * 2
    assert beats[0]["step"] == beats[1]["step"] == STEPS


# ---------------------------------------------------------------------- #
# no device read in the per-step calls
# ---------------------------------------------------------------------- #
READS = ("item", "cpu", "tolist", "numpy", "__float__", "__int__",
         "__bool__")


def test_per_step_monitor_calls_read_nothing_from_the_device(tmp_path,
                                                            monkeypatch):
    """Every Tensor read the host can make (item, cpu, tolist, numpy,
    float, int, bool) is counted while the monitor's per-step calls run
    (mark_step_start, add_phase, end_step) on the modular and the fused
    path: none on a step that closes no window; the window's reads come
    at the flush (the sanity check of the counter)."""
    state = {"active": False, "reads": 0}
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *args, _orig=orig, **kwargs):
            if state["active"]:
                state["reads"] += 1
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counted)
    _, tree = _jax_params(False)
    window = 4
    for fused in (False, True):
        eng = _port_engine(tree, _conf(
            8, gradient_accumulation_steps=2, fused_step={"enabled": fused},
            monitor=_monitor_block(tmp_path / f"f{fused}",
                                   write_interval=window)))
        mon = eng.monitor
        per_call = []

        def wrap(name):
            orig = getattr(mon, name)

            def call(*args, **kwargs):
                boundary = (name == "end_step"
                            and len(mon.stream._pending) + 1 >= window)
                state["active"], state["reads"] = True, 0
                try:
                    return orig(*args, **kwargs)
                finally:
                    state["active"] = False
                    per_call.append((name, boundary, state["reads"]))
            return call

        for name in ("mark_step_start", "add_phase", "end_step"):
            monkeypatch.setattr(mon, name, wrap(name))
        _drive(eng, [_ids(8, 16, seed=k) for k in range(STEPS * 2)], fused,
               2, torch.from_numpy)
        hot = [c for c in per_call if not c[1]]
        assert {c[0] for c in hot} == {"mark_step_start", "add_phase",
                                       "end_step"}
        assert all(reads == 0 for _, _, reads in hot), hot
        flushes = [c for c in per_call if c[1]]
        assert len(flushes) == STEPS // window
        assert all(reads > 0 for _, _, reads in flushes), flushes


# ---------------------------------------------------------------------- #
# the tensorboard block
# ---------------------------------------------------------------------- #
def _no_summary_writers(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)


def test_tensorboard_fallback_chain_matches_jax(tmp_path, monkeypatch):
    """With torch.utils.tensorboard and tensorboardX both unimportable,
    both engines fall back to the JSONL scalar writer, loudly and with
    the same degradation record; a null job_name degrades, it does not
    fail; an unwritable path disables the scalars without failing."""
    _, tree = _jax_params(False)
    jeng = _jax_engine(tree, _conf(1))
    eng = _port_engine(tree, _conf(8))
    _no_summary_writers(monkeypatch)
    out = {}
    for name, e in (("port", eng), ("jax", jeng)):
        tb = e.config.tensorboard_config
        tb.enabled, tb.output_path, tb.job_name = True, str(tmp_path / name), \
            None
        writer = e._configure_tensorboard()
        writer.add_scalar("Train/loss", 1.25, 7)
        writer.close()
        out[name] = (type(writer).__name__, open(writer.path).read())
    assert out["port"] == out["jax"]
    assert isinstance(eng._configure_tensorboard(),
                      writers.ScalarJsonlWriter)
    events = [[(e["subsystem"], e["from_tier"], e["to_tier"])
               for e in reg.get_registry().events()]
              for reg in (degradation, jax_degradation)]
    assert events[0] == events[1] == [("tensorboard", "torch", "jsonl")]
    blocked = tmp_path / "file"
    blocked.write_text("")
    eng.config.tensorboard_config.output_path = str(blocked)
    assert eng._configure_tensorboard() is None
    assert ("tensorboard", "torch", "disabled") in [
        (e["subsystem"], e["from_tier"], e["to_tier"])
        for e in degradation.get_registry().events()]


@pytest.mark.parametrize("backend", ["torch.utils.tensorboard",
                                     "tensorboardX"])
def test_tensorboard_takes_the_first_backend_that_imports(tmp_path,
                                                          monkeypatch,
                                                          backend):
    """torch.utils.tensorboard first, tensorboardX second (stand-in
    modules here, each a SummaryWriter that notes its log_dir): the first
    that imports is the writer, with no degradation; the job name joins
    the path."""
    class SummaryWriter:
        def __init__(self, log_dir):
            self.log_dir = log_dir

    for name in ("torch.utils.tensorboard", "tensorboardX"):
        if name == backend:
            module = types.ModuleType(name)
            module.SummaryWriter = SummaryWriter
        else:
            module = None
        monkeypatch.setitem(sys.modules, name, module)
    _, tree = _jax_params(False)
    eng = _port_engine(tree, _conf(8, tensorboard={
        "enabled": True, "output_path": str(tmp_path), "job_name": "run"}))
    assert isinstance(eng._summary_writer, SummaryWriter)
    assert eng._summary_writer.log_dir == str(tmp_path / "run")
    assert degradation.get_registry().events() == []


def test_boundary_scalars_and_monitor_scalars_match_jax(tmp_path,
                                                        monkeypatch):
    """The tensorboard block's scalars at write_interval 2
    (`_boundary_logging`: Train/Samples/train_loss at global step x
    train batch, Train/Samples/lr) and the monitor's tensorboard writer
    (Monitor/<field> a step record) through the JSONL fallback of both
    engines: the same tags at the same steps, the losses and the lr
    equal within the trajectory tolerance."""
    monkeypatch.setattr(jax_analysis, "audit_engine",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("no auditor")))
    _no_summary_writers(monkeypatch)
    _, tree = _jax_params(False)
    ids = [_ids(8, 16, seed=90 + k) for k in range(4)]
    scalars = {}
    for name in ("port", "jax"):
        extra = dict(
            steps_per_print=2,
            tensorboard={"enabled": True, "write_interval": 2,
                         "output_path": str(tmp_path / name / "tb")},
            monitor=_monitor_block(tmp_path / name, writers=[
                "jsonl", "tensorboard"], fleet=False, heartbeat=False))
        if name == "port":
            eng = _port_engine(tree, _conf(8, **extra))
            _drive_steps(eng, ids, torch.from_numpy)
        else:
            eng = _jax_engine(tree, _conf(1, **extra))
            _drive_steps(eng, ids, jnp.asarray)
        eng.monitor.close()
        eng._summary_writer.close()
        lines = [json.loads(line) for line in open(eng._summary_writer.path)]
        scalars[name] = {(d["tag"], d["step"]): d["value"] for d in lines}
    out, ref = scalars["port"], scalars["jax"]
    assert set(out) == set(ref)
    assert {("Train/Samples/train_loss", 16), ("Train/Samples/lr", 4),
            ("Monitor/loss", 3)} <= set(out)
    for key in out:
        if key[0] in ("Train/Samples/train_loss", "Train/Samples/lr",
                      "Monitor/loss", "Monitor/lr", "Monitor/loss_scale",
                      "Monitor/skipped_steps"):
            assert out[key] == pytest.approx(ref[key], rel=LOSS_RTOL), key


def _drive_steps(eng, batches, to_device):
    for b in batches:
        loss = eng.forward(to_device(b))
        eng.backward(loss)
        eng.step()


# ---------------------------------------------------------------------- #
# the config blocks
# ---------------------------------------------------------------------- #
def test_monitor_is_built_on_process_zero_only_when_enabled(tmp_path):
    _, tree = _jax_params(False)
    assert _port_engine(tree, _conf(8)).monitor is None
    eng = _port_engine(tree, _conf(8, monitor=_monitor_block(
        tmp_path, fleet=False, heartbeat=False, trace=False)))
    mon = eng.monitor
    assert mon.is_emitter and mon.fleet is None and mon.heartbeat is None
    assert mon.trace is None and mon.capture is None
    assert mon.stream._device == torch.device("cpu")
    mon.close()
    assert jax_monitor_mod.METRICS_JSONL == monitor_mod.METRICS_JSONL
    assert jax_monitor_mod.TRACE_JSON == monitor_mod.TRACE_JSON
