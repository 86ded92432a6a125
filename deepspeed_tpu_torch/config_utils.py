"""Helpers for parsing the JSON config (reference: deepspeed/runtime/config_utils.py).

A copy of deepspeed_tpu/config_utils.py.  The port keeps its own copy (ROADMAP.md A.2): the JAX package's module
is jax-free, but importing it runs deepspeed_tpu/__init__.py, which
imports JAX.
"""

import json


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys while JSON-parsing (reference: config_utils.py:23)."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d


def load_config_dict(config):
    """Accept a path to a JSON file or an already-parsed dict."""
    if isinstance(config, dict):
        return config
    if isinstance(config, str):
        with open(config, "r") as f:
            return json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
    raise TypeError(
        "Expected a dict or a path to a JSON config file, got {}".format(type(config)))
