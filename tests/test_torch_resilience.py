"""The resilience block of the port's engine (runtime/resilience/, the
engine's save_checkpoint / load_checkpoint / step under `"resilience"`)
against the JAX engine's, at the tiny GPT-2 of tests/test_torch_training.py:
atomic saves and their manifests, verified loads and their fallback, the
retention GC, the retry policy, preemption (the boundary's emergency save
under the modular and the fused path, the grace timer's forced save), the
modular sentinel's policies and its abort, and, in two gloo processes, the
agreed stop and the broadcast verified tag.

The two-process test runs this file as a worker script: its top level
imports only torch, numpy and the port, and the tests import JAX and the
other test modules where they run (tests/test_torch_distributed.py's
pattern)."""

import contextlib
import errno
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime import checkpoint as ckpt
from deepspeed_tpu_torch.runtime.resilience import (RetryPolicy,
                                                    SentinelAbort,
                                                    TrainingInterrupted,
                                                    get_registry, list_tags)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
ROWS, SEQ = 8, 16
MODEL = dict(vocab_size=128, n_positions=64, hidden_size=32, num_layers=2,
             num_heads=4)


def _block(**extra):
    """The resilience block of these tests: on, fast backoff, no lockstep
    re-verify (a port checkpoint holds no signature: ROADMAP.md A.14)."""
    return dict({"enabled": True, "io_backoff_seconds": 0.001,
                 "verify_lockstep_on_resume": False}, **extra)


def _conf(micro, gas=1, fused=False, **extra):
    return dict({"train_micro_batch_size_per_gpu": micro,
                 "gradient_accumulation_steps": gas,
                 "optimizer": {"type": "AdamW",
                               "params": {"lr": 1e-3, "weight_decay": 0.1}},
                 "zero_optimization": {"stage": 2},
                 "steps_per_print": 10 ** 9,
                 "fused_step": {"enabled": fused}}, **extra)


def _engine(conf, seed=0, dropout=0.1, state=None):
    dst.reset_mesh_context()
    cfg = GPT2Config(bf16=False, **dict(MODEL, embd_dropout=dropout,
                                        attn_dropout=dropout,
                                        hidden_dropout=dropout))
    model = GPT2Model(cfg)
    if state is None:
        model.init_params(torch.Generator().manual_seed(seed))
    return dst.initialize(model=model, config=conf, device="cpu",
                          model_parameters=state)[0]


def _batches(n, seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, MODEL["vocab_size"],
                                          (rows, SEQ)).astype(np.int32))
            for _ in range(n)]


def _windows(eng, it, n):
    return [float(eng.train_batch(it)) for _ in range(n)]


def _uninstall(*engines):
    for eng in engines:
        if eng._preemption is not None:
            eng._preemption.uninstall()


# ---------------------------------------------------------------------- #
# the worker: run as `python tests/test_torch_resilience.py SPEC RANK`
# ---------------------------------------------------------------------- #
def _worker_main(spec_path, rank):
    """One of two gloo processes: two steps and a save, rank 1 alone asks
    to stop, the next step's boundary agrees, both save the emergency tag
    and stop; then the emergency tag is lost (process 0 removes it), and a
    new engine in each process resumes with tag None: process 0 resolves
    the newest intact tag and broadcasts it, both load it."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    dst.init_distributed(dist_backend="gloo",
                         init_method="file://" + spec["rendezvous"])
    world = dist.get_world_size()
    conf = _conf(ROWS // world, resilience=_block(preemption={
        "enabled": True, "reraise": False, "save_dir": spec["save_dir"]}))
    rows = [b[rank * ROWS // world:(rank + 1) * ROWS // world]
            for b in spec["batches"]]
    eng = _engine(conf)
    it = iter([(b,) for b in rows])
    _windows(eng, it, 2)
    eng.save_checkpoint(spec["save_dir"])
    if rank == 1:
        eng._preemption.request_stop()
    out = {"degradations": get_registry().events()}
    try:
        _windows(eng, it, 1)
        out["stopped"] = None
    except TrainingInterrupted as stop:
        out["stopped"] = stop.emergency_tag
    out["saved_state"] = eng._flat[:eng.num_params].clone()
    dist.barrier()
    if rank == 0:
        # lost (a save under the group is in place, without a manifest to
        # verify a damaged file against)
        shutil.rmtree(os.path.join(spec["save_dir"], out["stopped"]))
    dist.barrier()
    other = _engine(conf, seed=1)
    path, _ = other.load_checkpoint(spec["save_dir"])
    _uninstall(other)
    out.update(resumed_from=os.path.basename(path),
               resumed_step=other.global_steps)
    torch.save(out, os.path.join(spec["out_dir"], f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main(sys.argv[1], int(sys.argv[2]))
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the test side
# ---------------------------------------------------------------------- #
@pytest.fixture(autouse=True)
def _fresh():
    from deepspeed_tpu.parallel import reset_mesh_context as jax_reset
    dst.reset_mesh_context()
    jax_reset()
    yield
    dst.reset_mesh_context()
    jax_reset()


def _jax_side():
    from . import test_torch_checkpoint as ck
    from . import test_torch_training as tr
    return ck, tr


def _port_pair(block):
    """The port's engine (micro 8, one rank) on the weights of the JAX
    engines below, dropout off, with `block`; and the batch."""
    ck, tr = _jax_side()
    eng = ck._port_engine(tr._jax_params(False)[1],
                          ck._conf(8, resilience=block))
    return eng, tr._ids(8, 16, seed=3)


def _jax_engine(block):
    """The JAX engine (micro 1 on the conftest's 8 devices) from the same
    weights, dropout off, with `block`."""
    ck, tr = _jax_side()
    return ck._jax_engine(tr._jax_params(False)[1],
                          ck._conf(1, resilience=block))


@pytest.fixture(scope="module")
def jax_saver():
    """One JAX engine with the resilience block (atomic saves, verified
    loads) for the file-level comparisons; built once (its programs take
    seconds to compile)."""
    return _jax_engine(_block())


def test_atomic_saves_match_the_jax_engine_and_load_across(tmp_path,
                                                           jax_saver):
    """The same resilience block (atomic saves) on both engines, one step
    each, a save: the same files in the tag, the manifest's keys and the
    files it lists the same; each engine loads the other's checkpoint (the
    parameters within 1e-6 of each leaf's largest entry); a resume that
    would re-verify the lockstep signature is refused naming A.14."""
    import jax
    import jax.numpy as jnp
    ck, tr = _jax_side()
    jeng = jax_saver
    eng, ids = _port_pair(_block())
    ck._steps(jeng, jnp.asarray(ids), 1)
    ck._steps(eng, torch.from_numpy(ids), 1)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jeng.save_checkpoint(jdir, tag="t")
    eng.save_checkpoint(pdir, tag="t")
    files = [sorted(os.listdir(os.path.join(d, "t"))) for d in (jdir, pdir)]
    assert files[0] == files[1] and "manifest.json" in files[1]
    manifests = []
    for d in (jdir, pdir):
        with open(os.path.join(d, "t", "manifest.json")) as f:
            manifests.append(json.load(f))
    assert sorted(manifests[0]) == sorted(manifests[1])
    assert sorted(manifests[0]["files"]) == sorted(manifests[1]["files"])
    assert all(sorted(e) == ["crc32", "size"]
               for m in manifests for e in m["files"].values())
    port_params = ck._port_params(eng)
    jax_params = jax.tree.map(np.asarray, jeng.params)
    jeng.load_checkpoint(pdir, tag="t")
    tr._assert_trees_close(jax.tree.map(np.asarray, jeng.params),
                           port_params, 0.0, 1e-6)
    eng.load_checkpoint(jdir, tag="t")
    tr._assert_trees_close(ck._port_params(eng), jax_params, 0.0, 1e-6)
    strict = ck._port_engine(tr._jax_params(False)[1], ck._conf(
        8, resilience=_block(verify_lockstep_on_resume=True)))
    with pytest.raises(NotImplementedError,
                       match=r"verify_lockstep_on_resume.*ROADMAP\.md A\.14"):
        strict.load_checkpoint(jdir, tag="t")


def test_a_damaged_newest_tag_falls_back_and_an_explicit_one_raises(
        tmp_path, jax_saver):
    """Two atomic saves, the newer's model file damaged: tag None resumes
    from the older (its step), the explicit tag raises the JAX engine's
    FileNotFoundError, word for word."""
    ck, tr = _jax_side()
    eng, ids = _port_pair(_block())
    path = str(tmp_path)
    for _ in range(2):
        ck._steps(eng, torch.from_numpy(ids), 1)
        eng.save_checkpoint(path)
    model = os.path.join(path, "global_step2", ck.MODEL_FILE)
    with open(model, "r+b") as f:
        f.seek(64)
        f.write(b"\x00\x01\x02\x03")
    fresh = ck._port_engine(tr._jax_params(False, seed=1)[1],
                            ck._conf(8, resilience=_block()))
    loaded, _ = fresh.load_checkpoint(path)
    assert os.path.basename(loaded) == "global_step1"
    assert fresh.global_steps == 1
    with pytest.raises(FileNotFoundError) as port_err:
        fresh.load_checkpoint(path, tag="global_step2")
    with pytest.raises(FileNotFoundError) as jax_err:
        jax_saver.load_checkpoint(path, tag="global_step2")
    assert str(port_err.value) == str(jax_err.value)
    assert "CRC32 mismatch" in str(port_err.value)


def test_retention_leaves_the_jax_engine_tags(tmp_path, jax_saver):
    """keep_last_n 2 and keep_every 3 over saves at steps 1-7 (the counter
    set by hand): both engines leave the same tags.  (The JAX engine is
    the module's, its resilience block given the retention keys.)"""
    import dataclasses
    block = _block(keep_last_n=2, keep_every=3)
    eng, _ = _port_pair(block)
    jeng = jax_saver
    saved_block = jeng.resilience
    jeng.resilience = dataclasses.replace(saved_block, keep_last_n=2,
                                          keep_every=3)
    left = []
    for name, e in (("jax", jeng), ("port", eng)):
        path = str(tmp_path / name)
        for step in range(1, 8):
            e.global_steps = step
            e.save_checkpoint(path)
        left.append(sorted(list_tags(path)))
    jeng.resilience = saved_block
    assert left[0] == left[1] == ["global_step3", "global_step6",
                                  "global_step7"]


def test_transient_io_errors_are_retried_and_counted(tmp_path, monkeypatch):
    """Two OSError(EIO) in a save: retried under the policy and counted
    (3 attempts, 2 retries, 1 recovered); the counters ride the next
    save's client state; a non-transient OSError and other errors raise
    at once.  The seeded backoff is the JAX policy's."""
    from deepspeed_tpu.runtime.resilience.retry import (
        RetryPolicy as JaxRetryPolicy)
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    eng = _engine(_conf(ROWS, resilience=_block()), dropout=0.0)
    assert isinstance(eng._retry_policy, RetryPolicy)
    assert eng._retry_policy.retries == 3
    real = ckpt.save_checkpoint_state
    faults = {"left": 2, "err": errno.EIO}

    def flaky(*args, **kwargs):
        if faults["left"]:
            faults["left"] -= 1
            raise OSError(faults["err"], "injected")
        return real(*args, **kwargs)

    monkeypatch.setattr(engine_mod.ckpt_mod, "save_checkpoint_state", flaky)
    eng.save_checkpoint(str(tmp_path), tag="a")
    counters = {"attempts": 3, "retries": 2, "recovered": 1, "gave_up": 0}
    assert eng._retry_policy.counters == counters
    eng.save_checkpoint(str(tmp_path), tag="b")
    with open(tmp_path / "b" / "ds_meta.json") as f:
        saved = json.load(f)["client_state"]["retry_counters"]
    # sealed before the save's own attempt, as in the JAX engine
    assert {k: saved[k] for k in counters} == counters
    faults.update(left=1, err=errno.ENOENT)
    with pytest.raises(FileNotFoundError):
        eng.save_checkpoint(str(tmp_path), tag="c")
    faults.update(left=4, err=errno.EIO)
    with pytest.raises(OSError) as err:
        eng.save_checkpoint(str(tmp_path), tag="d")
    assert err.value.retry_attempts == 4
    assert eng._retry_policy.counters["gave_up"] == 1
    ours, theirs = RetryPolicy(seed=3), JaxRetryPolicy(seed=3)
    assert ([ours.backoff(k) for k in range(1, 6)]
            == [theirs.backoff(k) for k in range(1, 6)])


@pytest.mark.parametrize("fused", [False, True])
def test_a_stop_saves_at_the_boundary_and_resumes_bitwise(tmp_path, fused):
    """Dropout 0.1, gas 2: two windows, request_stop(), the third window
    ends in an emergency_step3 save and TrainingInterrupted (reraise
    false); an engine from other weights resumes from the directory's
    latest tag, and its two windows, parameters, Adam's state and
    generators equal an uninterrupted run's bitwise."""
    conf = _conf(ROWS, gas=2, fused=fused, resilience=_block(preemption={
        "enabled": True, "reraise": False, "save_dir": str(tmp_path)}))
    batches = [(b,) for b in _batches(10, seed=5)]
    eng = _engine(conf)
    it = iter(batches)
    _windows(eng, it, 2)
    eng._preemption.request_stop()
    with pytest.raises(TrainingInterrupted) as stop:
        _windows(eng, it, 1)
    assert stop.value.emergency_tag == "emergency_step3"
    assert ckpt.read_latest_tag(str(tmp_path)) == "emergency_step3"
    resumed = _engine(conf, seed=1)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.global_steps == 3
    run_b = _windows(resumed, iter(batches[6:]), 2)
    whole = _engine(conf)
    run_a = _windows(whole, iter(batches), 5)
    _uninstall(resumed, whole)
    assert run_b == run_a[3:]
    assert torch.equal(resumed._flat, whole._flat)
    assert all(torch.equal(resumed.opt_state[k], whole.opt_state[k])
               for k in whole.opt_state)
    assert torch.equal(resumed._rngs[0].get_state(),
                       whole._rngs[0].get_state())


def test_the_grace_timer_saves_the_last_step_when_no_boundary_comes(
        tmp_path):
    """grace_s 0.05: a stop requested between steps and no boundary for a
    while: the timer thread saves emergency_step2_forced, the state of the
    two steps taken; the next boundary stops with that tag and saves no
    other."""
    conf = _conf(ROWS, fused=True, resilience=_block(preemption={
        "enabled": True, "reraise": False, "grace_s": 0.05,
        "save_dir": str(tmp_path)}))
    batches = [(b,) for b in _batches(4, seed=7)]
    eng = _engine(conf)
    it = iter(batches)
    _windows(eng, it, 2)
    eng._preemption.request_stop()
    deadline = time.monotonic() + 10
    while eng._preemption.forced_tag is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng._preemption.forced_tag == "emergency_step2_forced"
    other = _engine(_conf(ROWS, fused=True, resilience=_block()), seed=1)
    other.load_checkpoint(str(tmp_path), tag="emergency_step2_forced")
    assert torch.equal(other._flat, eng._flat) and other.global_steps == 2
    assert torch.equal(other._rngs[0].get_state(), eng._rngs[0].get_state())
    with pytest.raises(TrainingInterrupted) as stop:
        _windows(eng, it, 1)
    assert stop.value.emergency_tag == "emergency_step2_forced"
    assert list_tags(str(tmp_path)) == ["emergency_step2_forced"]


SENTINEL = {"enabled": True, "warmup_steps": 3, "k_sigma": 0.01,
            "anomaly_budget": 3}


@pytest.fixture(scope="module")
def jax_sentinel_engine(tmp_path_factory):
    """One JAX engine with the sentinel on, and a save of its first state:
    each policy's run loads that state and takes a new sentinel of its
    policy (the programs do not depend on the policy, and compile once)."""
    path = str(tmp_path_factory.mktemp("sentinel_start"))
    jeng = _jax_engine(_block(sentinel=dict(SENTINEL, policy="warn")))
    jeng.save_checkpoint(path, tag="start")
    return jeng, path


@pytest.mark.parametrize("policy", ["warn", "skip_step", "rewind"])
def test_modular_sentinel_counters_match_the_jax_engine(
        tmp_path, policy, jax_sentinel_engine):
    """The modular sentinel (loss and grad norm) with warmup 3, k_sigma
    0.01 and a budget of 3 on one fixed batch: after warmup every step is
    an anomaly.  warn trains through (anomalies only); skip_step skips
    (the same loss again) until SentinelAbort at the budget; rewind loads
    the checkpoint saved after step 2 until the budget is spent.  After
    every step both engines hold the same counters, steps and
    skipped_steps, and abort at the same step."""
    import jax.numpy as jnp
    from deepspeed_tpu.runtime.resilience.sentinel import (
        SentinelAbort as JaxSentinelAbort)
    from deepspeed_tpu.runtime.resilience.sentinel import (
        TrainingSentinel as JaxTrainingSentinel)
    ck, _ = _jax_side()
    jeng, start = jax_sentinel_engine
    jeng.load_checkpoint(start, tag="start")
    jeng.sentinel = JaxTrainingSentinel(**{
        k: v for k, v in SENTINEL.items() if k != "enabled"}, policy=policy)
    eng, ids = _port_pair(_block(sentinel=dict(SENTINEL, policy=policy)))
    history = []
    for name, e, x in (("jax", jeng, jnp.asarray(ids)),
                       ("port", eng, torch.from_numpy(ids))):
        seen = []
        for step in range(8):
            if step == 2 and policy == "rewind":
                e.save_checkpoint(str(tmp_path / name), tag="good")
            try:
                ck._steps(e, x, 1)
            except (SentinelAbort, JaxSentinelAbort) as abort:
                seen.append(("abort", abort.diagnostic["step"],
                             abort.diagnostic["anomalies_seen"]))
                break
            seen.append((e.global_steps, e.skipped_steps,
                         e.sentinel.counters()))
        history.append(seen)
    assert history[0] == history[1]
    last = history[1][-1]
    if policy == "warn":
        assert last[2]["anomalies_seen"] == 5 and last[1] == 0
    else:
        assert last[0] == "abort"
        assert eng.sentinel.counters()["rewinds" if policy == "rewind"
                                       else "steps_skipped"] >= 2


def test_initialize_takes_resilience_and_refuses_monitor_and_chaos():
    """The resilience block at its defaults (io_retries 3) builds the
    retry policy; the monitor's MoE routing records are refused naming
    A.10 (the monitor itself is ported), resilience.chaos naming A.13."""
    eng = _engine(_conf(ROWS, resilience={"enabled": True}), dropout=0.0)
    assert eng._retry_policy.retries == 3 and eng.sentinel is None
    for block, item in (({"monitor": {"enabled": True,
                                      "moe": {"enabled": True}}}, r"A\.10"),
                        ({"resilience": {"enabled": True, "chaos": {
                            "enabled": True}}}, r"A\.13")):
        with pytest.raises(NotImplementedError,
                           match=rf"ROADMAP\.md .*{item}"):
            _engine(_conf(ROWS, **block), dropout=0.0)


def test_two_processes_stop_together_and_agree_on_the_verified_tag(
        tmp_path):
    """Two gloo processes (this file as the worker): rank 1 alone requests
    the stop; both save emergency_step3 at the boundary (the atomic save
    recorded as degraded to in-place under the group) and stop; with that
    tag lost, both resume from global_step2, the tag process 0 resolved
    and broadcast."""
    spec = os.path.join(str(tmp_path), "spec.pt")
    torch.save({"rendezvous": os.path.join(str(tmp_path), "rdv"),
                "save_dir": os.path.join(str(tmp_path), "ckpt"),
                "out_dir": str(tmp_path),
                "batches": _batches(3, seed=11)}, spec)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DS_", "OMPI_"))
           and k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                         "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(MASTER_ADDR="localhost", MASTER_PORT="29500",
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(2):
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
                      weights_only=False) for r in range(2)]
    assert [r["stopped"] for r in res] == ["emergency_step3"] * 2
    assert torch.equal(res[0]["saved_state"], res[1]["saved_state"])
    for r in res:
        assert any(e["subsystem"] == "checkpoint"
                   and (e["from_tier"], e["to_tier"]) == ("atomic",
                                                          "in_place")
                   for e in r["degradations"])
    assert [(r["resumed_from"], r["resumed_step"]) for r in res] == \
        [("global_step2", 2)] * 2
