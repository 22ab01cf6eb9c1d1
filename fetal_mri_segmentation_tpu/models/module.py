"""Plain-JAX parameter trees for the model family.

A model is a frozen dataclass of hyper-parameters with one method,
``forward(scope, x, **kwargs)``. Its variables are nested dicts of arrays:

    {"params": {"enc0_conv1": {"conv": {"kernel": ..., "bias": ...}}, ...},
     "batch_stats": {...}}      # only when the model has BatchNorm

``Scope`` is the only state the forward sees: it hands out the arrays at a
path, records the BatchNorm statistics a training forward produces, and
draws the dropout keys. ``init`` traces the forward abstractly to learn
every parameter's path, shape and initializer, then draws the values from
the key, so shapes are written down in one place (the forward) and no
full-size forward runs at init time.

The surface matches what callers used before (``model.init(rng, x)``,
``model.apply(variables, x, train=..., mutable=["batch_stats"],
rngs={"dropout": key})``), and the tree paths are those of the Keras-era
checkpoint layout that ``utils/keras_import.py`` maps onto.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Initializer = Callable[[jax.Array, Tuple[int, ...], Any], jax.Array]

lecun_normal: Initializer = jax.nn.initializers.lecun_normal()
zeros: Initializer = jax.nn.initializers.zeros
ones: Initializer = jax.nn.initializers.ones


@dataclasses.dataclass
class _Root:
    variables: Dict[str, Any]
    initializing: bool
    rngs: Dict[str, jax.Array]
    specs: List[Tuple[Tuple[str, ...], Tuple[int, ...], Initializer]] = (
        dataclasses.field(default_factory=list))
    new_stats: Dict[Tuple[str, ...], jax.Array] = dataclasses.field(
        default_factory=dict)
    rng_counts: Dict[str, int] = dataclasses.field(default_factory=dict)


def _lookup(tree: Dict[str, Any], path: Sequence[str]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _nest(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


class Scope:
    """A view of the variables at one path of the tree."""

    def __init__(self, root: _Root, path: Tuple[str, ...] = ()):
        self._root = root
        self.path = path

    def child(self, name: str) -> "Scope":
        return Scope(self._root, self.path + (name,))

    @property
    def initializing(self) -> bool:
        return self._root.initializing

    def param(self, name: str, shape: Sequence[int],
              init: Initializer = zeros) -> jax.Array:
        path = self.path + (name,)
        shape = tuple(int(s) for s in shape)
        if self._root.initializing:
            self._root.specs.append((path, shape, init))
            return jnp.zeros(shape, jnp.float32)
        value = _lookup(self._root.variables["params"], path)
        if tuple(value.shape) != shape:
            raise ValueError(f"param {'/'.join(path)} has shape "
                             f"{tuple(value.shape)}, model needs {shape}")
        return value

    def batch_stat(self, name: str, shape: Sequence[int],
                   init: Initializer) -> jax.Array:
        """A running statistic: read from ``batch_stats`` (its initial
        value while initializing)."""
        path = self.path + (name,)
        if self._root.initializing:
            self._root.specs.append((("batch_stats",) + path,
                                     tuple(shape), init))
            return init(None, tuple(shape), jnp.float32)
        return _lookup(self._root.variables["batch_stats"], path)

    def set_batch_stat(self, name: str, value: jax.Array) -> None:
        self._root.new_stats[self.path + (name,)] = value

    def make_rng(self, name: str) -> jax.Array:
        """A fresh key from stream ``name`` (falls back to ``params``)."""
        rngs = self._root.rngs
        stream = name if name in rngs else "params"
        if stream not in rngs:
            raise ValueError(f"forward needs an rng for {name!r}: pass "
                             f"rngs={{{name!r}: key}}")
        n = self._root.rng_counts.get(stream, 0)
        self._root.rng_counts[stream] = n + 1
        return jax.random.fold_in(rngs[stream], n)


def _path_key(rng: jax.Array, path: Tuple[str, ...]) -> jax.Array:
    return jax.random.fold_in(rng, zlib.crc32("/".join(path).encode()))


class Model:
    """Base for the model dataclasses: ``init``/``apply`` over ``forward``."""

    def forward(self, scope: Scope, x: jax.Array, **kwargs) -> jax.Array:
        raise NotImplementedError

    def init(self, rng: jax.Array, x, **kwargs) -> Dict[str, Any]:
        """Variables for input ``x`` (shape and dtype only are read)."""
        root = _Root(variables={}, initializing=True, rngs={"params": rng})
        x = jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x))
        jax.eval_shape(lambda v: self.forward(Scope(root), v, **kwargs), x)
        params, stats = {}, {}
        for path, shape, init in root.specs:
            if path[0] == "batch_stats":
                stats[path[1:]] = init(None, shape, jnp.float32)
            else:
                params[path] = init(_path_key(rng, path), shape, jnp.float32)
        variables = {"params": _nest(params)}
        if stats:
            variables["batch_stats"] = _nest(stats)
        return variables

    def apply(self, variables: Dict[str, Any], x, *,
              rngs: Optional[Dict[str, jax.Array]] = None,
              mutable: Sequence[str] | bool = False, **kwargs):
        """Forward pass. With ``mutable=["batch_stats"]`` returns
        ``(y, {"batch_stats": updated})``."""
        root = _Root(variables=variables, initializing=False,
                     rngs=dict(rngs or {}))
        y = self.forward(Scope(root), x, **kwargs)
        if not mutable:
            return y
        stats = variables.get("batch_stats", {})
        flat = {tuple(getattr(k, "key", k) for k in p): v for p, v in
                jax.tree_util.tree_flatten_with_path(stats)[0]}
        flat.update(root.new_stats)
        return y, {"batch_stats": _nest(flat)}
