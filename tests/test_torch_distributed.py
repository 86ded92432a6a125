"""One process a rank: the port's `init_distributed` (utils/distributed.py)
against the JAX module's discovery, and the training engine over a
torch.distributed process group (the mesh's process-group transport)
against the single-controller mesh at the same W, bitwise, and the JAX
engine at data W, at the tiny GPT-2 of tests/test_torch_training.py.

The processes are this file run as a worker script: its top level imports
only torch, numpy and the port, never JAX.  They join a gloo group
through `init_distributed` from torchrun-style env and a `file://`
rendezvous under the test's temporary directory, run the cases a spec
lists (the weights and global batches made here from seeded numpy), and
write their results for the test to read.  Each group of processes has
its own deadline and is killed when it passes it.  Everything runs on the
CPU with one thread a process, and the references here too, so that
every reduction runs in the same order.
"""

import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import GPT2Config, GPT2Model
from deepspeed_tpu_torch.parallel import MeshContext
from deepspeed_tpu_torch.parallel import groups as pgroups
from deepspeed_tpu_torch.utils import distributed as pdist
from deepspeed_tpu_torch.utils import logging as plogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
STEPS = 4
ROWS, SEQ = 8, 16  # the global batch of every case


# ---------------------------------------------------------------------- #
# the worker: run as `python tests/test_torch_distributed.py SPEC RANK`
# ---------------------------------------------------------------------- #
def _rows(batch, world, rank):
    """This process's rows: the rank-th of `world` contiguous blocks."""
    n = batch.shape[0] // world
    return torch.from_numpy(batch[rank * n:(rank + 1) * n])


def _engine(spec, case, state_key=None, training_data=None):
    dst.reset_mesh_context()
    cfg = GPT2Config(bf16=case.get("bf16", False), **spec["model"])
    return dst.initialize(
        model=GPT2Model(cfg), config=case["config"], device="cpu",
        model_parameters=spec["states"][state_key or case.get("bf16", False)],
        training_data=training_data)[0]


def _step(eng, rows):
    loss = eng.forward(rows)
    eng.backward(loss)
    eng.step()
    return loss.item()


def _state(eng):
    """The whole fp32 parameters, Adam's moments and the count (gathered
    over the processes: every process calls it)."""
    n = eng.num_params
    return {"flat": eng._flat[:n].clone(),
            **{k: torch.from_numpy(eng._gathered(k)[:n].copy())
               for k in ("mu", "nu")},
            "count": int(eng.opt_state["count"])}


def _case_train(spec, case, world, rank):
    eng = _engine(spec, case)
    losses = [_step(eng, _rows(b, world, rank)) for b in case["batches"]]
    return {"losses": losses, **_state(eng),
            "world_size": eng.world_size, "local_ranks": eng.local_ranks}


def _case_overflow(spec, case, world, rank):
    """A step, then inf in the last process's grad range before the
    second step: every process must skip it."""
    eng = _engine(spec, case)
    batch = _rows(case["batches"][0], world, rank)
    _step(eng, batch)
    before = _state(eng)
    eng.backward(eng.forward(batch))
    if rank == world - 1:
        eng._acc[0][5] = float("inf")
    eng.step()
    skipped = {"overflow": eng.overflow, "after": _state(eng)}
    _step(eng, batch)
    return {"before": before, "skipped": skipped,
            "next_overflow": eng.overflow, "next_count":
            int(eng.opt_state["count"])}


def _case_save(spec, case, world, rank):
    """Steps, a save, and a load into a fresh engine of the same world."""
    eng = _engine(spec, case)
    for b in case["batches"]:
        _step(eng, _rows(b, world, rank))
    path = eng.save_checkpoint(spec["save_dir"], tag=case["tag"])
    saved = _state(eng)
    other = _engine(spec, case, state_key="other")
    other.load_checkpoint(spec["save_dir"])
    return {"path": path, "saved": saved, "reloaded": _state(other)}


def _case_load(spec, case, world, rank):
    """A load of a checkpoint written at another world, then steps."""
    eng = _engine(spec, case, state_key="other")
    eng.load_checkpoint(case["load_dir"])
    loaded = _state(eng)
    losses = [_step(eng, _rows(b, world, rank)) for b in case["batches"]]
    return {"loaded": loaded, "losses": losses}


def _case_loader(spec, case, world, rank):
    eng = _engine(spec, case, training_data=list(case["dataset"]))
    return {"batches": [np.asarray(b) for b in eng.training_dataloader]}


def _case_probe(spec, case, world, rank):
    """The groups API, the log rank and the refusals under the group."""
    eng = _engine(spec, case)
    out = {name: getattr(pgroups, name)() for name in (
        "get_data_parallel_rank", "get_data_parallel_world_size",
        "get_world_size", "get_data_parallel_group")}
    out["log_rank"] = plogging._process_rank()
    out["process_count"] = eng.mesh.process_count
    for what, fn in (
            ("mesh_data", lambda: MeshContext.create(data=2 * world,
                                                     devices=["cpu"])),
            ("permute", lambda: eng.mesh.permute([torch.zeros(2)], "data",
                                                 [(0, 1)])),
            ("psum_scatter", lambda: eng.mesh.psum_scatter(
                [torch.zeros(4)], "data", 0))):
        try:
            fn()
            out[what] = None
        except (ValueError, NotImplementedError) as exc:
            out[what] = f"{type(exc).__name__}: {exc}"
    return out


WORKER_CASES = {"train": _case_train, "overflow": _case_overflow,
                "save": _case_save, "load": _case_load,
                "loader": _case_loader, "probe": _case_probe}


def _worker_main(spec_path, rank):
    import torch.distributed as dist

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    world = spec["world"]
    dst.init_distributed(dist_backend="gloo",
                         init_method="file://" + spec["rendezvous"])
    assert dist.get_world_size() == world and dist.get_rank() == rank
    results = {case["name"]: WORKER_CASES[case["kind"]](spec, case, world,
                                                        rank)
               for case in spec["cases"]}
    torch.save(results, os.path.join(spec["out_dir"], f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main(sys.argv[1], int(sys.argv[2]))
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the test side (imports JAX and the other test modules lazily, so that
# the worker above never does)
# ---------------------------------------------------------------------- #
@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _helpers():
    from . import test_torch_data_parallel as dp
    from . import test_torch_training as tr
    return dp, tr


def _global_batches(seed, n=STEPS, rows=ROWS):
    _, tr = _helpers()
    return [tr._ids(rows, SEQ, seed=seed + i) for i in range(n)]


LAMB = {"optimizer": {"type": "Lamb", "params": {"lr": 1e-2,
                                                  "weight_decay": 0.01}}}


def _cases(world):
    """The cases a group of `world` processes runs: (name, kind, config
    arguments of test_torch_data_parallel._config, extra)."""
    dp, _ = _helpers()
    micro = ROWS // world
    cases = [dict(name=f"stage{stage}", kind="train",
                  config=dp._config(world, micro, stage),
                  batches=_global_batches(3)) for stage in (0, 1, 2)]
    if world == 2:
        cases += [
            dict(name="bf16", kind="train", bf16=True,
                 config=dp._config(world, micro, 2, bf16=True),
                 batches=_global_batches(3)),
            dict(name="gas2", kind="train",
                 config=dp._config(world, micro // 2, 2, gas=2),
                 batches=_global_batches(20, n=2 * STEPS, rows=ROWS // 2)),
            dict(name="clip", kind="train",
                 config=dp._config(world, micro, 2, gradient_clipping=0.05),
                 batches=_global_batches(30)),
            dict(name="lamb", kind="train",
                 config=dp._config(world, micro, 1, **LAMB),
                 batches=_global_batches(40)),
            dict(name="overflow", kind="overflow",
                 config=dp._config(world, micro, 2),
                 batches=_global_batches(50, n=1)),
            dict(name="save", kind="save", tag="w2",
                 config=dp._config(world, micro, 2),
                 batches=_global_batches(60, n=2)),
            dict(name="loader", kind="loader",
                 config=dp._config(world, 3, 2),
                 dataset=_global_batches(70, n=1, rows=20)[0]),
            dict(name="probe", kind="probe",
                 config=dp._config(world, micro, 2))]
    else:
        cases.append(dict(name="load", kind="load",
                          config=dp._config(world, micro, 2),
                          batches=_global_batches(80, n=2)))
    return cases


def _launch(world, root):
    """Start `world` worker processes; returns (procs, out_dir, logs)."""
    out_dir = os.path.join(root, f"w{world}")
    os.makedirs(out_dir)
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
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             os.path.join(root, f"spec{world}.pt"), str(rank)],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
        logs.append(log)
    return procs, out_dir, logs


def _wait(world, procs, out_dir, logs, deadline):
    """Each worker's results; a worker that fails or outlives the deadline
    fails the group (every worker of it killed)."""
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        tails = []
        for r, _ in bad:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tails.append(f"rank {r}:\n" + f.read()[-3000:])
        pytest.fail(f"a group of {world} processes failed (rank, exit "
                    f"code; -9 = killed at the {GROUP_TIMEOUT_S} s "
                    f"deadline): {bad}\n" + "\n".join(tails))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups (W = 2 and W = 4), started together; before them, the
    W = 1 checkpoint that the W = 4 group loads."""
    dp, tr = _helpers()
    from .test_torch_checkpoint import _conf as ckpt_conf
    from .test_torch_checkpoint import _port_engine as ckpt_engine
    from .test_torch_checkpoint import _steps as ckpt_steps

    root = str(tmp_path_factory.mktemp("dist"))
    cfgs = {bf16: GPT2Config(bf16=bf16, **tr.TINY) for bf16 in (False, True)}
    from deepspeed_tpu_torch.models import gpt2_params_from_jax
    states = {bf16: gpt2_params_from_jax(tr._jax_params(bf16)[1], cfgs[bf16])
              for bf16 in (False, True)}
    states["other"] = gpt2_params_from_jax(tr._jax_params(False, seed=1)[1],
                                           cfgs[False])
    w1_dir = os.path.join(root, "w1_ckpt")
    with _one_thread():
        eng = ckpt_engine(tr._jax_params(False)[1], ckpt_conf(ROWS))
        ckpt_steps(eng, torch.from_numpy(_global_batches(90, n=1)[0]), 2)
        eng.save_checkpoint(w1_dir, tag="w1")
    dst.reset_mesh_context()
    started, cases_by_world = {}, {}
    for world in (2, 4):
        cases = _cases(world)
        for case in cases:
            case.setdefault("load_dir", w1_dir)
        cases_by_world[world] = {c["name"]: c for c in cases}
        torch.save({"world": world, "model": tr.TINY, "states": states,
                    "cases": cases,
                    "rendezvous": os.path.join(root, f"rdv{world}"),
                    "out_dir": os.path.join(root, f"w{world}"),
                    "save_dir": os.path.join(root, f"ckpt{world}")},
                   os.path.join(root, f"spec{world}.pt"))
        started[world] = (*_launch(world, root),
                          time.monotonic() + GROUP_TIMEOUT_S)
    out = {world: _wait(world, *args) for world, args in started.items()}
    out.update(root=root, w1_dir=w1_dir, cases=cases_by_world)
    return out


def _single_controller(case):
    """The same case on the single-controller CPU mesh at W ranks, one
    thread: (losses, engine)."""
    dp, tr = _helpers()
    bf16 = case.get("bf16", False)
    with _one_thread():
        return dp._port_run(tr._jax_params(bf16)[1], case["config"],
                            case["batches"], bf16)


def _assert_state_equal(got, want, what):
    for key in ("flat", "mu", "nu"):
        assert torch.equal(got[key], want[key]), (what, key)
    assert got["count"] == want["count"], what


def _sc_state(eng):
    n = eng.num_params
    return {"flat": eng._flat[:n].clone(),
            **{k: torch.from_numpy(eng._gathered(k)[:n].copy())
               for k in ("mu", "nu")},
            "count": int(eng.opt_state["count"])}


# ---------------------------------------------------------------------- #
# 1. discovery: the JAX module's decisions
# ---------------------------------------------------------------------- #
DISCOVERY = {
    "dslaunch": ({"DS_COORDINATOR": "10.0.0.1:1234", "DS_NUM_PROCESSES": "4",
                  "DS_PROCESS_ID": "2"}, {}),
    "torchrun": ({"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "2345",
                  "RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, {}),
    "torchrun_default_port": ({"MASTER_ADDR": "host", "RANK": "3",
                               "WORLD_SIZE": "4"}, {}),
    "dslaunch_before_torchrun": ({"DS_COORDINATOR": "a:1",
                                  "DS_NUM_PROCESSES": "2",
                                  "DS_PROCESS_ID": "1", "MASTER_ADDR": "b",
                                  "RANK": "0", "WORLD_SIZE": "8"}, {}),
    "openmpi": ({"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
                 "MASTER_ADDR": "mpihead"}, {}),
    "openmpi_without_address": ({"OMPI_COMM_WORLD_SIZE": "8",
                                 "OMPI_COMM_WORLD_RANK": "5"}, {}),
    "openmpi_discovery_off": ({"OMPI_COMM_WORLD_SIZE": "8",
                               "OMPI_COMM_WORLD_RANK": "5",
                               "MASTER_ADDR": "mpihead"},
                              {"auto_mpi_discovery": False}),
    "overrides": ({"MASTER_ADDR": "h", "RANK": "1", "WORLD_SIZE": "2"},
                  {"rank": 0, "world_size": 3}),
    "rank_without_world_size": ({"MASTER_ADDR": "h", "RANK": "1"},
                                {"world_size": 2}),
    "world_of_one": ({"MASTER_ADDR": "h", "RANK": "0", "WORLD_SIZE": "1"},
                     {}),
    "no_env": ({}, {}),
}
_DISCOVERY_KEYS = ("DS_COORDINATOR", "DS_NUM_PROCESSES", "DS_PROCESS_ID",
                   "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                   "LOCAL_RANK", "OMPI_COMM_WORLD_SIZE",
                   "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")


def _set_env(monkeypatch, env):
    for key in _DISCOVERY_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


@pytest.mark.parametrize("case", sorted(DISCOVERY))
def test_discovery_matches_the_jax_module(monkeypatch, case):
    """The same env and arguments: the port joins a group exactly when the
    JAX module initializes, with its coordinator, process count and
    process id (jax.distributed.initialize and init_process_group
    intercepted)."""
    import jax
    from deepspeed_tpu.utils import distributed as jdist

    env, kwargs = DISCOVERY[case]
    _set_env(monkeypatch, env)
    calls = {}
    monkeypatch.setattr(jdist, "_INITIALIZED", False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.__setitem__("jax", kw))
    jdist.init_distributed(**kwargs)
    monkeypatch.setattr(pdist, "_INITIALIZED", False)
    monkeypatch.setattr(
        torch.distributed, "init_process_group",
        lambda backend, **kw: calls.__setitem__("port", (backend, kw)))
    pdist.init_distributed(dist_backend="gloo", **kwargs)
    assert ("jax" in calls) == ("port" in calls), calls
    if "jax" in calls:
        want, (backend, got) = calls["jax"], calls["port"]
        assert backend == "gloo"
        assert got == {"init_method": f"tcp://{want['coordinator_address']}",
                       "rank": want["process_id"],
                       "world_size": want["num_processes"]}


def test_nccl_raises_without_a_card_and_init_method_passes_through(
        monkeypatch):
    """The default backend is NCCL: with no card it raises before joining
    (no gloo, no CPU); an explicit init_method replaces the coordinator's
    tcp:// address; the card is LOCAL_RANK, else OpenMPI's local rank,
    else the process id modulo the visible cards."""
    _set_env(monkeypatch, DISCOVERY["torchrun"][0])
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pdist, "_INITIALIZED", False)
    with pytest.raises(RuntimeError, match="does not fall back to gloo"):
        pdist.init_distributed()
    assert calls == []
    pdist.init_distributed(dist_backend="gloo", init_method="file:///x")
    assert calls == [("gloo", {"init_method": "file:///x", "rank": 1,
                               "world_size": 2})]
    assert pdist.local_device_index(7) == 1
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "3")
    assert pdist.local_device_index(7) == 3
    monkeypatch.delenv("OMPI_COMM_WORLD_LOCAL_RANK")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pdist.local_device_index(7) == 3
    assert dst.init_distributed is pdist.init_distributed


# ---------------------------------------------------------------------- #
# 2. W processes = the single controller at W ranks, bitwise
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("world,stage", [(2, 0), (2, 1), (2, 2), (4, 0),
                                         (4, 1), (4, 2)])
def test_processes_equal_the_single_controller(runs, world, stage):
    """4 steps of the tiny GPT-2 in fp32 on 8 global rows, each process
    its rows: every process's losses (the mean over all W ranks), whole
    parameters and gathered Adam moments equal the single-controller
    mesh's at W ranks bitwise; ZeRO-1 and ZeRO-2 bitwise equal."""
    name = f"stage{stage}"
    case = runs["cases"][world][name]
    losses, eng = _single_controller(case)
    want = _sc_state(eng)
    for rank, res in enumerate(runs[world]):
        got = res[name]
        assert got["world_size"] == world and got["local_ranks"] == [rank]
        assert got["losses"] == losses, (rank, got["losses"], losses)
        _assert_state_equal(got, want, (world, stage, rank))
    if stage == 2:
        for res in runs[world]:
            assert torch.equal(res["stage1"]["flat"], res["stage2"]["flat"])


@pytest.mark.parametrize("world", [2, 4])
def test_processes_within_the_jax_engine(runs, world):
    """The ZeRO-2 run of W processes against the JAX engine at data W on
    the same global batches: losses rtol 1e-4, parameters within 1e-4 of
    each leaf's largest entry (test_torch_data_parallel.py's fp32
    tolerances, the key third of attn_qkvb left out)."""
    dp, tr = _helpers()
    case = runs["cases"][world]["stage2"]
    _, tree = tr._jax_params(False)
    ref, ref_params, _ = dp._jax_run(tree, case["config"], world,
                                     case["batches"])
    cfg = GPT2Config(bf16=False, **tr.TINY)
    model = GPT2Model(cfg)
    flat = runs[world][0]["stage2"]["flat"]
    off = 0
    with torch.no_grad():
        for _, p in model.named_parameters():
            p.copy_(flat[off:off + p.numel()].view(p.shape))
            off += p.numel()
    from deepspeed_tpu_torch.models import gpt2_params_to_jax
    got = gpt2_params_to_jax(dict(model.named_parameters()), cfg)
    np.testing.assert_allclose(runs[world][0]["stage2"]["losses"], ref,
                               rtol=1e-4)
    tr._assert_trees_close(dp._drop_key_bias(got),
                           dp._drop_key_bias(ref_params), 0.0, 1e-4)


@pytest.mark.parametrize("name", ["bf16", "gas2", "clip", "lamb"])
def test_bf16_accumulation_clipping_and_lamb_at_two_processes(runs, name):
    """bf16 (ZeRO-2), gas 2 (ZeRO-2), gradient clipping 0.05 (ZeRO-2,
    the norm summed over the processes) and Lamb (ZeRO-1, each
    parameter's norms summed over the processes, a range cutting through
    one) at W = 2 processes: bitwise the single controller at W = 2."""
    case = runs["cases"][2][name]
    losses, eng = _single_controller(case)
    want = _sc_state(eng)
    for rank, res in enumerate(runs[2]):
        assert res[name]["losses"] == losses, (rank, name)
        _assert_state_equal(res[name], want, (name, rank))


def test_overflow_on_one_process_skips_the_step_everywhere(runs):
    """inf in the last process's ZeRO-2 grad range only: every process
    reports the overflow and keeps its parameters, moments and count
    bitwise; the next step proceeds on all."""
    for res in runs[2]:
        out = res["overflow"]
        assert out["skipped"]["overflow"] is True
        _assert_state_equal(out["skipped"]["after"], out["before"],
                            "skipped step")
        assert out["next_overflow"] is False and out["next_count"] == 2


def test_dataloader_shard_matches_the_jax_loader(runs):
    """Each process's loader yields the rows the JAX DeepSpeedDataLoader
    yields with the same batch (micro-batch x W / P), data-parallel world
    P and rank."""
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader
    dataset = list(runs["cases"][2]["loader"]["dataset"])
    for rank, res in enumerate(runs[2]):
        want = list(DeepSpeedDataLoader(dataset, batch_size=3,
                                        data_parallel_world_size=2,
                                        data_parallel_rank=rank))
        got = res["loader"]["batches"]
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------- #
# 3. checkpoints
# ---------------------------------------------------------------------- #
def test_save_at_two_processes_equals_the_single_controller(runs, tmp_path):
    """A save at W = 2 processes (process 0 writes) holds the single
    controller's W = 2 save: the same files, keys and arrays, the same
    client state (TORCH_RNG_KEY included) but for the topology's
    process_count, 2.  Both processes reload it bitwise; the port loads it
    at W = 1 in one process and the JAX engine loads it too."""
    import jax

    from .test_torch_checkpoint import (MODEL_FILE, OPTIM_FILE, _conf,
                                        _jax_engine, _port_engine, _read,
                                        _assert_trees_within, _port_params)
    from deepspeed_tpu_torch.runtime.engine import TORCH_RNG_KEY

    dp, tr = _helpers()
    case = runs["cases"][2]["save"]
    save_dir = os.path.join(runs["root"], "ckpt2")
    for res in runs[2]:
        assert res["save"]["path"] == os.path.join(save_dir, "w2")
        _assert_state_equal(res["save"]["reloaded"], res["save"]["saved"],
                            "reload")
    _, eng = _single_controller(case)
    eng.save_checkpoint(str(tmp_path), tag="w2")
    got, want = _read(save_dir, "w2"), _read(str(tmp_path), "w2")
    for name in (MODEL_FILE, OPTIM_FILE):
        assert sorted(got[name]) == sorted(want[name])
        for key in want[name]:
            np.testing.assert_array_equal(got[name][key], want[name][key])
    topo_got = got["client_state"]["partition_topology"]
    topo_want = want["client_state"]["partition_topology"]
    assert topo_got.pop("process_count") == 2
    assert topo_want.pop("process_count") == 1
    assert got["client_state"] == want["client_state"]
    assert len(got["client_state"][TORCH_RNG_KEY]) == 2
    with open(os.path.join(save_dir, "latest")) as f:
        assert f.read().strip() == "w2"
    one = _port_engine(tr._jax_params(False, seed=1)[1], _conf(ROWS))
    one.load_checkpoint(save_dir)
    _assert_state_equal(_sc_state(one), _sc_state(eng), "W = 1 load")
    jeng = _jax_engine(tr._jax_params(False)[1], _conf(1))
    jeng.load_checkpoint(save_dir, tag="w2")
    _assert_trees_within(jax.tree.map(np.asarray, jeng.params),
                         _port_params(eng), 0.0)


def test_four_processes_load_a_one_rank_save(runs):
    """Four processes load the W = 1 checkpoint written in this process:
    each cuts its own range, so the gathered state equals the saving
    engine's bitwise, and the next 2 steps equal the single controller's
    at W = 4 after the same load, bitwise."""
    from .test_torch_checkpoint import _conf, _port_engine
    dp, tr = _helpers()
    saver = _port_engine(tr._jax_params(False)[1], _conf(ROWS))
    saver.load_checkpoint(runs["w1_dir"])
    want = _sc_state(saver)
    case = runs["cases"][4]["load"]
    with _one_thread():
        eng = dp._port_engine(tr._jax_params(False, seed=1)[1],
                              case["config"])
        eng.load_checkpoint(runs["w1_dir"])
        losses = []
        for b in case["batches"]:
            loss = eng.forward(torch.from_numpy(b))
            eng.backward(loss)
            eng.step()
            losses.append(loss.item())
    for rank, res in enumerate(runs[4]):
        _assert_state_equal(res["load"]["loaded"], want, ("load", rank))
        assert res["load"]["losses"] == losses, rank


# ---------------------------------------------------------------------- #
# 4. the groups API and the refusals under a process group
# ---------------------------------------------------------------------- #
def test_groups_log_rank_and_refusals_under_processes(runs):
    """Under 2 processes: the groups API gives each its global rank and
    W (the JAX groups API's values), log_dist reads the process's rank; a
    mesh whose data axis is not the process count raises naming both; the
    collective tier's primitives raise naming ROADMAP.md A.4c."""
    for rank, res in enumerate(runs[2]):
        out = res["probe"]
        assert out["get_data_parallel_rank"] == rank
        assert out["get_data_parallel_world_size"] == 2
        assert out["get_world_size"] == 2
        assert out["get_data_parallel_group"] == ("data", "expert")
        assert out["log_rank"] == rank and out["process_count"] == 2
        assert out["mesh_data"].startswith("ValueError") and \
            "world of 2 processes" in out["mesh_data"] and \
            "data=4" in out["mesh_data"]
        for prim in ("permute", "psum_scatter"):
            assert out[prim].startswith("NotImplementedError") and \
                "ROADMAP.md A.4c" in out[prim], out[prim]


def test_the_worker_side_imports_no_jax():
    """What a worker process runs, this file's top level, imports nothing
    of JAX or of the JAX package (checked on the source: the test side
    imports them inside its functions)."""
    import ast
    with open(__file__) as f:
        tree = ast.parse(f.read())
    top = [node for node in tree.body
           if isinstance(node, (ast.Import, ast.ImportFrom))]
    names = [alias.name for node in top if isinstance(node, ast.Import)
             for alias in node.names]
    names += [node.module for node in top
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert "torch" in names and "deepspeed_tpu_torch" in names
    banned = [n for n in names if n.split(".")[0] in ("jax", "jaxlib")
              or n == "deepspeed_tpu" or n.startswith("deepspeed_tpu.")]
    assert not banned, banned
