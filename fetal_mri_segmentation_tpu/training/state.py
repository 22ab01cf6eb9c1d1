"""Training state: params + optimizer + (optional) BatchNorm stats + RNG.

The reference's equivalent is the compiled Keras model object holding weights
and Adam slots (reference: unet3d/model/unet.py model.compile(Adam, ...),
training.py::load_old_model restoring arch+weights+optimizer from .h5).
Here state is an explicit pytree — jit-friendly and saved leaf by leaf
(training/checkpoint.py).

The learning rate lives INSIDE the optimizer state via
``optax.inject_hyperparams`` so the epoch-level schedules of the reference
(step decay / ReduceLROnPlateau — callbacks that mutate the Keras optimizer's
lr variable) become a plain functional update of ``opt_state.hyperparams``
with no recompilation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    opt_state: Any
    batch_stats: Any  # {} when the model has no BatchNorm
    tx: optax.GradientTransformation = dataclasses.field(
        metadata=dict(static=True))

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads):
        updates, new_opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=new_opt_state)

    @property
    def learning_rate(self) -> float:
        return float(self.opt_state.hyperparams["learning_rate"])

    def set_learning_rate(self, lr: float) -> "TrainState":
        hp = dict(self.opt_state.hyperparams)
        hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
        return self.replace(opt_state=self.opt_state._replace(hyperparams=hp))


def scale_by_keras_adam(b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-7) -> optax.GradientTransformation:
    """Adam with the reference's (Keras) exact epsilon semantics.

    Keras Adam computes ``var -= alpha(t) * m / (sqrt(v) + eps)`` with
    ``alpha(t) = lr * sqrt(1 - b2^t) / (1 - b1^t)`` — the bias corrections
    are folded into the step size and eps is added to the UNCORRECTED
    sqrt(v). optax's `scale_by_adam` instead adds eps to the corrected
    sqrt(v_hat), so its effective eps is smaller by sqrt(1 - b2^t) (650x
    at t=4) and it defaults to 1e-8 vs Keras's 1e-7 — a measured ~1%
    per-element update difference early in training on this repo's
    gradient scales. Matching the reference semantics makes a Keras .h5
    continuation (utils/keras_opt.py) land on the same trajectory.
    Reuses optax.ScaleByAdamState, so checkpointing/import are unchanged.
    """

    def init_fn(params):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        return optax.ScaleByAdamState(count=jnp.zeros([], jnp.int32),
                                      mu=zeros,
                                      nu=jax.tree_util.tree_map(
                                          jnp.zeros_like, params))

    def update_fn(updates, state, params=None):
        del params
        count_inc = optax.safe_int32_increment(state.count)
        mu = jax.tree_util.tree_map(lambda g, m: b1 * m + (1 - b1) * g,
                                    updates, state.mu)
        nu = jax.tree_util.tree_map(lambda g, v: b2 * v + (1 - b2) * g * g,
                                    updates, state.nu)
        t = count_inc.astype(jnp.float32)
        alpha = jnp.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        out = jax.tree_util.tree_map(
            lambda m, v: alpha * m / (jnp.sqrt(v) + eps), mu, nu)
        return out, optax.ScaleByAdamState(count=count_inc, mu=mu, nu=nu)

    return optax.GradientTransformation(init_fn, update_fn)


def make_optimizer(initial_learning_rate: float,
                   clip_norm: Optional[float] = None
                   ) -> optax.GradientTransformation:
    """Adam with a runtime-adjustable learning rate (reference: Adam(lr))."""
    return optax.inject_hyperparams(
        lambda learning_rate: optax.chain(
            *([optax.clip_by_global_norm(clip_norm)] if clip_norm else []),
            scale_by_keras_adam(),
            optax.scale_by_learning_rate(learning_rate)),
    )(learning_rate=initial_learning_rate)


def create_abstract_state(model, config,
                          tx: Optional[optax.GradientTransformation] = None
                          ) -> TrainState:
    """`create_train_state`'s tree as ShapeDtypeStructs — ZERO compile/compute.

    Serving cold-start lever: restoring a checkpoint only needs the state's
    STRUCTURE as a template, but `create_train_state` jit-compiles and runs
    a full `model.init` forward to produce throwaway values (~30 s for even
    a small 3D U-Net on one CPU core). `jax.eval_shape` traces the same
    constructor abstractly; the checkpoint restores concrete arrays into
    the abstract template (see checkpoint.py::load_old_model).
    """
    tx = tx or make_optimizer(config.initial_learning_rate)
    return jax.eval_shape(
        lambda r: create_train_state(model, config, r, tx=tx),
        jax.random.PRNGKey(0))


def create_train_state(model, config, rng: jax.Array,
                       tx: Optional[optax.GradientTransformation] = None
                       ) -> TrainState:
    """Initialize params (NDHWC example input derived from the config)."""
    shape = config.patch_shape if config.patch_shape else config.image_shape
    x = jnp.zeros((1,) + tuple(shape) + (config.nb_channels,), jnp.float32)
    variables = model.init(rng, x)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    tx = tx or make_optimizer(config.initial_learning_rate)
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), batch_stats=batch_stats,
                      tx=tx)
