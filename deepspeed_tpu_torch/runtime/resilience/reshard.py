"""Checkpoints that load at another mesh shape: the reshard-on-load check
(counterpart of deepspeed_tpu/runtime/resilience/reshard.py).

A checkpoint saved at data-parallel world W must load at any W'.  The
consolidated layout (runtime/checkpoint.py) stores whole leaves, so a
load at W' only cuts each leaf into the new ranks' ranges.  What this
module adds is the contract:

  * ``partition_topology`` (engine-side) is written into the tag's
    ``ds_meta.json`` client state at save: mesh axis sizes, zero stage,
    hpZ group, world and process counts, layout.
  * ``check_reshard`` validates a load: same topology, silent; a resize of
    the ZeRO axes only, allowed and logged as a reshard; a resize of
    another axis in a layout that is not consolidated, or a world-size
    change on a tag that recorded NO topology (ambiguous), raises
    ``ReshardError`` naming the tag and both topologies.

The JAX module's ``verify_lockstep_resume`` compares a signature that
analysis/ traces from the step program; it comes with that package
(ROADMAP.md A.14).
"""

import json
import os
from typing import Any, Dict, List, Optional

from ...utils.logging import logger
from ..zero.partition import topologies_equal, topology_reshard_problems

# client-state key under which save_checkpoint records the topology
TOPOLOGY_KEY = "partition_topology"
SIGNATURE_KEY = "lockstep_signature"
TOPOLOGY_FORMAT_VERSION = 1


class ReshardError(RuntimeError):
    """A checkpoint cannot be mapped onto the requested topology, or the
    mapping would be ambiguous.  Carries the tag and both topologies."""

    def __init__(self, tag: str, saved: Optional[Dict[str, Any]],
                 requested: Dict[str, Any], problems: List[str]):
        self.tag = str(tag)
        self.saved_topology = saved
        self.requested_topology = requested
        self.problems = list(problems)
        super().__init__(
            f"checkpoint tag {self.tag!r} cannot be resharded onto the "
            f"requested topology: {'; '.join(self.problems)} "
            f"[saved topology: {_topo_str(saved)}; requested topology: "
            f"{_topo_str(requested)}]")


def _topo_str(topo: Optional[Dict[str, Any]]) -> str:
    if not topo:
        return "<none recorded>"
    mesh = topo.get("mesh") or {}
    live = {a: s for a, s in mesh.items() if int(s) > 1} or {"total": 1}
    parts = [f"mesh={live}", f"zero_stage={topo.get('zero_stage')}"]
    if topo.get("hpz_group_size"):
        parts.append(f"hpz={topo.get('hpz_group_size')}")
    if topo.get("process_count"):
        parts.append(f"procs={topo.get('process_count')}")
    return " ".join(parts)


def read_saved_client_state(load_dir: str, tag: str) -> Dict[str, Any]:
    """The tag's ds_meta.json client state ({} when absent), read first on
    load so that the topology check fails before any array is read."""
    meta = os.path.join(load_dir, str(tag), "ds_meta.json")
    if not os.path.isfile(meta):
        return {}
    try:
        with open(meta) as f:
            return json.load(f).get("client_state", {}) or {}
    except (OSError, ValueError) as e:
        logger.warning(f"checkpoint tag {tag!r}: unreadable ds_meta.json "
                       f"({e}); topology validation skipped")
        return {}


def check_reshard(tag: str, saved_client: Dict[str, Any],
                  current_topology: Dict[str, Any],
                  current_world_size: Optional[int] = None) -> bool:
    """Validate loading `tag` onto `current_topology`: True when the load
    reshards (the topology changed along the ZeRO axes only, or the layout
    is consolidated), False when the topologies match.  Raises
    ReshardError on a change no layout can map, or on a tag with no
    recorded topology whose dp world size (`dp_world_size`) differs from
    the current one."""
    saved_topo = saved_client.get(TOPOLOGY_KEY)
    if not saved_topo:
        saved_w = saved_client.get("dp_world_size")
        if (saved_w is not None and current_world_size is not None
                and int(saved_w) != int(current_world_size)):
            raise ReshardError(
                tag, None, current_topology,
                [f"tag records no {TOPOLOGY_KEY} but was saved at dp "
                 f"world size {saved_w} != current {current_world_size}: "
                 "the saved partition layout is ambiguous; re-save with a "
                 "version that records the topology, or load at the "
                 "original world size and re-save"])
        return False
    if saved_topo.get("layout") == "consolidated":
        # whole leaves: any mesh cuts them into its own ranges (a
        # structural mismatch still fails when the arrays are read)
        problems = []
    else:
        problems = topology_reshard_problems(saved_topo, current_topology)
    if problems:
        raise ReshardError(tag, saved_topo, current_topology, problems)
    if topologies_equal(saved_topo, current_topology):
        return False
    if int(saved_topo.get("zero_stage") or 0) != int(
            current_topology.get("zero_stage") or 0):
        logger.warning(
            f"checkpoint tag {tag!r}: zero stage changes "
            f"{saved_topo.get('zero_stage')} -> "
            f"{current_topology.get('zero_stage')} on load; the stored "
            "values are whole leaves, cut under the new stage's ranges")
    logger.warning(
        f"resharding checkpoint tag {tag!r}: saved "
        f"[{_topo_str(saved_topo)}] -> requested "
        f"[{_topo_str(current_topology)}]")
    return True
