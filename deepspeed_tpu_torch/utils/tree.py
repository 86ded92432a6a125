"""Nested-dict trees in the JAX package's flattening order, without JAX.

A tree is nested dicts, lists and tuples; anything else is a leaf.  Dict
keys are taken in sorted order, as `jax.tree.leaves` takes them, so leaf i
here is leaf i of the JAX package's tree of the same structure (the
offload tier's state and file names depend on that order).  None holds no
leaf, as in JAX.
"""

from typing import Any, Callable, List, Tuple


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def tree_flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves in JAX order, rebuild), where rebuild(new_leaves) returns a
    tree of the same structure holding new_leaves."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            return len(leaves) - 1
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return type(node)(walk(child) for child in node)

    spec = walk(tree)

    def rebuild(new_leaves):
        def fill(node):
            if node is None:
                return None
            if isinstance(node, int):
                return new_leaves[node]
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            return type(node)(fill(child) for child in node)
        return fill(spec)

    return leaves, rebuild


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]
