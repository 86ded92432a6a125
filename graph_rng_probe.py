"""What torch's generator-state forms do for a recompute inside a captured
CUDA graph: does the recompute of a draw, made inside the graph, draw the
forward's numbers again on every replay?

    python3 graph_rng_probe.py

A window draws `a` from the generator g (a layer's forward), then `b` (a
later layer), then recomputes `a` from a generator derived from g's state
before `a` (activation checkpointing's recompute).  Each way of deriving
it is captured into one torch.cuda.CUDAGraph (g registered with it) and
replayed REPLAYS times, in a process of its own, and each replay's
recomputed draw is compared with that replay's forward draw.  The
recompute's generator of the first two ways is made before the capture
and registered with the graph too: torch refuses to make a CUDA
generator inside a capture.

- get_state: a host copy of g's state, set on another generator (what
  runtime/activation_checkpointing's checkpoint_with_generator does
  outside a capture, there on a generator made at the recompute);
- graphsafe_get_state: g.graphsafe_get_state() before `a`, set with
  graphsafe_set_state on another generator for the recompute;
- clone_state_in_capture: g.clone_state() before `a`, inside the capture;
- clone_state_registered: g.clone_state() before the capture, registered
  with the graph, no host work between replays;
- clone_state_registered_reset: the same, its state set on the host
  before every replay to g's (runtime/fused_step.py's way, through
  RecomputeGenerators).

Prints one JSON line a way ({"way", "ok", "matches": [bool a replay] or
"error"}), then the torch and CUDA versions and the card's name.
"""

import json
import subprocess
import sys

import torch

REPLAYS = 3
N = 1 << 16
WAYS = ("get_state", "graphsafe_get_state", "clone_state_in_capture",
        "clone_state_registered", "clone_state_registered_reset")


def probe(way):
    g = torch.Generator(device="cuda").manual_seed(1234)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    if way.startswith("clone_state_registered"):
        registered = g.clone_state()
    else:
        registered = torch.Generator(device="cuda")
    if way != "clone_state_in_capture":
        graph.register_generator_state(registered)
    out = {}
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        if way == "get_state":
            state = g.get_state()
        elif way == "graphsafe_get_state":
            state = g.graphsafe_get_state()
        elif way == "clone_state_in_capture":
            state = g.clone_state()
        out["a"] = torch.rand(N, device="cuda", generator=g)
        out["b"] = torch.rand(N, device="cuda", generator=g)
        again = registered
        if way == "get_state":
            again.set_state(state)
        elif way == "graphsafe_get_state":
            again.graphsafe_set_state(state)
        elif way == "clone_state_in_capture":
            again = state
        out["again"] = torch.rand(N, device="cuda", generator=again)
    matches = []
    for _ in range(REPLAYS):
        if way == "clone_state_registered_reset":
            registered.set_state(g.get_state())
        graph.replay()
        torch.cuda.synchronize()
        matches.append(bool(torch.equal(out["a"], out["again"])))
    return matches


def main():
    if sys.argv[1:2] == ["--way"]:
        way = sys.argv[2]
        try:
            row = {"way": way, "ok": True, "matches": probe(way)}
        except Exception as exc:  # the finding is the error itself
            row = {"way": way, "ok": False,
                   "error": f"{type(exc).__name__}: {exc}"[:400]}
        print(json.dumps(row), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("graph_rng_probe: no CUDA device", file=sys.stderr)
        return 1
    for way in WAYS:
        proc = subprocess.run([sys.executable, __file__, "--way", way],
                              capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        print(lines[-1] if lines else json.dumps(
            {"way": way, "ok": False, "exit": proc.returncode,
             "stderr": proc.stderr[-400:]}), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
