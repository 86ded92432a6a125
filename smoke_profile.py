"""Sampling profile of a whole chip_smoke.py run, to find where its time
goes.  A thread samples the main thread's stack every 10 ms; per phase
(run_phase's name) it counts the samples each function was on the stack
for (inclusive; lines of chip_smoke.py itself by line), the innermost
frames and whole stacks.  The overhead is a few percent of the run.

    python3 smoke_profile.py OUT.json [chip_smoke.py's arguments]

Runs on the card like chip_smoke.py and prints what it prints; OUT.json
holds {"per_phase": [[phase, samples]], "incl": [[phase, frame, n]],
"leaf": ..., "stacks": [[phase, "f;g;h", n]]}.  Samples are relative:
scale a phase's by its `seconds` in the run's output."""

import collections
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = sys.argv[1]
sys.argv = [os.path.join(ROOT, "chip_smoke.py")] + sys.argv[2:]
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

MAIN = threading.get_ident()
phase = ["<start>"]
incl, leaf, stacks = (collections.Counter() for _ in range(3))
per_phase = collections.Counter()
done = threading.Event()


def frame_key(f):
    name = f.f_code.co_filename
    short = name.split("/site-packages/")[-1].split(ROOT + "/")[-1]
    if short == "chip_smoke.py":
        return f"chip_smoke:{f.f_code.co_name}:{f.f_lineno}"
    return f"{short}:{f.f_code.co_name}"


def sample():
    while not done.wait(0.01):
        f = sys._current_frames().get(MAIN)
        if f is None:
            continue
        p = phase[0]
        keys = []
        while f is not None:
            keys.append(frame_key(f))
            f = f.f_back
        per_phase[p] += 1
        leaf[(p, keys[0])] += 1
        for k in set(keys):
            incl[(p, k)] += 1
        stacks[(p, ";".join(reversed(keys[:40])))] += 1


run_phase = chip_smoke.run_phase


def named_phase(name, fn, *args):
    phase[0] = name
    try:
        return run_phase(name, fn, *args)
    finally:
        phase[0] = f"<after {name}>"


chip_smoke.run_phase = named_phase
threading.Thread(target=sample, daemon=True).start()
try:
    chip_smoke.main()
finally:
    done.set()
    time.sleep(0.05)
    with open(OUT, "w") as fh:
        json.dump({"per_phase": per_phase.most_common(),
                   "incl": [[p, k, n] for (p, k), n
                            in incl.most_common(6000)],
                   "leaf": [[p, k, n] for (p, k), n
                            in leaf.most_common(3000)],
                   "stacks": [[p, s, n] for (p, s), n
                              in stacks.most_common(3000)]}, fh)
