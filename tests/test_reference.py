"""The models against the plain float32 reference (models/reference.py),
the formulation gates, and the plain-JAX parameter trees against the
golden file written by the flax.linen implementation they replace.

On the CPU both sides run in exact float32, so the tolerances here are
float32 reassociation noise (the folded and fused forms reorder the same
multiply-accumulates): 2e-5 absolute on sigmoid/softmax outputs. On a GPU
the models run bf16 (or TF32) and chip_smoke.py checks them against the
same reference with wider limits (docs/PERF.md, "H100 bring-up").
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fetal_mri_segmentation_tpu.config import Config
from fetal_mri_segmentation_tpu.models import Isensee2017, UNet3D, layers
from fetal_mri_segmentation_tpu.models.reference import reference_forward

ATOL = 2e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_models.npz")


def _x(shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).normal(size=shape),
                       jnp.float32)


def _perturbed(variables, seed=1):
    """Move every leaf off its init value (zero biases, unit scales would
    hide mistakes in the bias/scale handling)."""
    leaves, tdef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        l + 0.05 * jax.random.normal(k, l.shape) for l, k in zip(leaves, keys)])


CASES = {
    "unet": dict(model_name="unet", depth=3, n_base_filters=4),
    "isensee": dict(model_name="isensee", depth=3, n_base_filters=4,
                    n_segmentation_levels=2, n_labels=2, labels=(1, 2),
                    activation_name="softmax"),
}


@pytest.mark.parametrize("form", ["parity", "dilated"])
@pytest.mark.parametrize("fold", ["off", (1, 1, 2)])
@pytest.mark.parametrize("family", ["unet", "isensee"])
def test_model_matches_reference(family, fold, form, monkeypatch):
    """Every formulation (fold on/off x decoder form) is the reference's
    function on the same parameters. B=2 so the dilated form engages."""
    monkeypatch.setattr(layers, "DILATED_BACKENDS",
                        frozenset({"cpu"}) if form == "dilated"
                        else frozenset())
    cfg = Config(compute_dtype="float32", fold_level0=fold,
                 patch_shape=(16, 16, 16), **CASES[family])
    from fetal_mri_segmentation_tpu.models import build_model
    model = build_model(cfg)
    x = _x((2, 16, 16, 16, 1))
    v = _perturbed(model.init(jax.random.PRNGKey(0), x))
    got = np.asarray(model.apply(v, x))
    want = np.asarray(reference_forward(cfg, v, x))
    assert got.shape == want.shape == (2, 16, 16, 16, cfg.n_labels)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(batch_normalization=True),
                                dict(instance_normalization=True),
                                dict(deconvolution=True)],
                         ids=["batchnorm", "instancenorm", "deconv"])
def test_unet_options_match_reference(kw):
    cfg = Config(model_name="unet", depth=2, n_base_filters=4,
                 compute_dtype="float32", fold_level0="off",
                 patch_shape=(8, 8, 8), **kw)
    model = UNet3D(depth=2, n_base_filters=4, dtype=jnp.float32,
                   fold_level0="off", **kw)
    x = _x((2, 8, 8, 8, 1), seed=3)
    v = _perturbed(model.init(jax.random.PRNGKey(0), x))
    np.testing.assert_allclose(np.asarray(model.apply(v, x)),
                               np.asarray(reference_forward(cfg, v, x)),
                               atol=ATOL)


@pytest.mark.parametrize("family", ["unet", "isensee"])
def test_gradient_matches_reference(family):
    """The training gradient (logits path, as the train step uses it
    through the loss) equals the reference's."""
    cfg = Config(compute_dtype="float32", fold_level0="off",
                 patch_shape=(16, 16, 16), **CASES[family])
    from fetal_mri_segmentation_tpu.models import build_model
    model = build_model(cfg)
    x = _x((1, 16, 16, 16, 1), seed=5)
    target = _x((1, 16, 16, 16, cfg.n_labels), seed=6)
    v = _perturbed(model.init(jax.random.PRNGKey(0), x))

    def loss_model(p):
        return jnp.mean((model.apply({"params": p}, x) - target) ** 2)

    def loss_ref(p):
        return jnp.mean((reference_forward(cfg, {"params": p}, x)
                         - target) ** 2)

    g_model = jax.tree_util.tree_leaves(jax.grad(loss_model)(v["params"]))
    g_ref = jax.tree_util.tree_leaves(jax.grad(loss_ref)(v["params"]))
    # relative to the largest gradient anywhere: conv biases feeding an
    # InstanceNorm have an exactly-zero true gradient, so a per-leaf scale
    # would compare rounding noise with rounding noise
    scale = max(float(np.abs(np.asarray(b)).max()) for b in g_ref)
    for a, b in zip(g_model, g_ref):
        np.testing.assert_allclose(np.asarray(a) / scale,
                                   np.asarray(b) / scale, atol=1e-5)


# ---------------------------------------------------------------------------
# formulation gates
# ---------------------------------------------------------------------------

GPU_DILATED = "gpu" in layers.DILATED_BACKENDS
GPU_FOLD = "gpu" in layers.FOLD_BACKENDS


@pytest.mark.parametrize("platform,dilated,fold", [
    ("cpu", False, False),
    ("gpu", GPU_DILATED, GPU_FOLD),
    ("cuda", GPU_DILATED, GPU_FOLD),   # jax.export's name for the GPU
    ("some_new_backend", False, False),
])
def test_gate_resolution(platform, dilated, fold):
    assert layers._dilated_backend_ok(platform) is dilated
    assert layers._fold_backend_ok(platform) is fold


def test_gates_follow_the_measured_backends():
    """The GPU gates are the outcome recorded in docs/PERF.md (H100
    bring-up): no formulation switch on any backend beats the plain form
    there, so both gates are closed everywhere."""
    assert layers.DILATED_BACKENDS == frozenset()
    assert layers.FOLD_BACKENDS == frozenset()


def test_trace_for_platforms_requires_every_target(monkeypatch):
    monkeypatch.setattr(layers, "DILATED_BACKENDS", frozenset({"gpu"}))
    with layers.trace_for_platforms(["cuda"]):
        assert layers._dilated_backend_ok()
    with layers.trace_for_platforms(["cuda", "cpu"]):
        assert not layers._dilated_backend_ok()
        # an explicit platform still answers for itself
        assert layers._dilated_backend_ok("cuda")
    assert layers._TRACE_PLATFORMS is None


# ---------------------------------------------------------------------------
# plain-JAX parameter trees vs the golden file
# ---------------------------------------------------------------------------

GOLDEN_MODELS = {
    "unet": UNet3D(n_labels=1, depth=2, n_base_filters=4, dtype=jnp.float32,
                   fold_level0="off"),
    "unet_nofuse": UNet3D(n_labels=2, depth=3, n_base_filters=2,
                          dtype=jnp.float32, fuse_decoder=False,
                          activation_name="softmax", fold_level0="off"),
    "unet_deconv": UNet3D(n_labels=1, depth=2, n_base_filters=4,
                          dtype=jnp.float32, deconvolution=True,
                          fold_level0="off"),
    "unet_bn": UNet3D(n_labels=1, depth=2, n_base_filters=4,
                      dtype=jnp.float32, batch_normalization=True,
                      fold_level0="off"),
    "unet_in": UNet3D(n_labels=1, depth=2, n_base_filters=4,
                      dtype=jnp.float32, instance_normalization=True,
                      fold_level0="off"),
    "isensee": Isensee2017(n_labels=2, depth=3, n_base_filters=4,
                           n_segmentation_levels=2, dtype=jnp.float32,
                           fold_level0="off"),
}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _golden_variables(g, name):
    prefix = name + "|var|"
    out = {}
    for key in g.files:
        if key.startswith(prefix):
            node = out
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(g[key])
    return out


@pytest.mark.parametrize("name", sorted(GOLDEN_MODELS))
def test_golden_tree_and_outputs(name):
    """Same tree paths, shapes and collections as the checkpoints written
    before; same outputs on the golden parameters."""
    g = np.load(GOLDEN)
    model = GOLDEN_MODELS[name]
    x = g["input"]
    want_vars = _golden_variables(g, name)
    got = _flat(model.init(jax.random.PRNGKey(0), x))
    want = _flat(want_vars)
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    np.testing.assert_allclose(np.asarray(model.apply(want_vars, x)),
                               g[name + "|out_eval"], atol=1e-6)
    if name == "isensee":
        np.testing.assert_allclose(
            np.asarray(model.apply(want_vars, x, logits=True)),
            g[name + "|out_logits"], atol=1e-5)


def test_golden_batchnorm_training_stats():
    g = np.load(GOLDEN)
    v = _golden_variables(g, "unet_bn")
    y, mutated = GOLDEN_MODELS["unet_bn"].apply(
        v, g["input"], train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(np.asarray(y), g["unet_bn|out_train"],
                               atol=1e-6)
    for k, val in _flat(mutated["batch_stats"]).items():
        np.testing.assert_allclose(val, g["unet_bn|new_stats|" + k],
                                   atol=1e-6)
