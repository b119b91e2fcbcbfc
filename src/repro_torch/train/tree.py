"""The port's parameter trees: nested dicts (keys visited sorted, as
``jax.tree_util`` visits them) and lists of tensors.  Path keys read like
``jax.tree_util.keystr``: ``['layers'][0]['attn']['wq']``.  The JAX package
stacks layers on a leading axis where the port keeps a list, so the two
packages' leaves come in another order and number: compare them through
``models.convert``."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["leaves", "leaves_with_paths", "unflatten", "tree_map"]


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path key, leaf) for every leaf, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in leaves_with_paths(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(tree_like, new_leaves) -> Any:
    """``tree_like``'s structure holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same
    structure)."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])
