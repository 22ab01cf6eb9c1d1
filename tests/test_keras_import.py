"""Keras -> parameter-tree weight import + forward numerical parity.

This is the Dice-parity cornerstone: if the same weights produce the same
probabilities on the same input, per-case Dice matches the reference by
construction (SURVEY.md section 7 hard parts: Conv3DTranspose semantics).
Keras runs with the TF CPU backend here.
"""

import numpy as np
import pytest

keras = pytest.importorskip("keras")

from fetal_mri_segmentation_tpu.utils.keras_import import (
    import_keras_unet_weights, keras_weight_list_from_model)


@pytest.fixture(scope="module")
def pair():
    """A tiny Keras U-Net and our UNet3D with imported weights."""
    import jax
    import jax.numpy as jnp
    from keras import layers

    from fetal_mri_segmentation_tpu.models import UNet3D

    depth, nbf, shape = 2, 2, (8, 8, 8)
    inp = keras.Input(shape=shape + (1,))
    x = inp
    skips = []
    for level in range(depth):
        f = nbf * 2 ** level
        x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
        x = layers.Conv3D(f * 2, 3, padding="same", activation="relu")(x)
        if level < depth - 1:
            skips.append(x)
            x = layers.MaxPooling3D(2)(x)
    for level in range(depth - 2, -1, -1):
        x = layers.Conv3DTranspose(x.shape[-1], 2, strides=2)(x)
        x = layers.Concatenate()([x, skips[level]])
        f = skips[level].shape[-1]
        x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
        x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
    out = layers.Conv3D(1, 1, activation="sigmoid")(x)
    kmodel = keras.Model(inp, out)

    fmodel = UNet3D(n_labels=1, depth=depth, n_base_filters=nbf,
                    deconvolution=True, dtype=jnp.float32)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape + (1,)))
    params = import_keras_unet_weights(
        variables["params"], keras_weight_list_from_model(kmodel))
    return kmodel, fmodel, {"params": params}, shape


def test_forward_parity_with_keras(pair):
    kmodel, fmodel, variables, shape = pair
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2,) + shape + (1,)).astype(np.float32)
    want = np.asarray(kmodel(x))
    got = np.asarray(fmodel.apply(variables, x))
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=2e-5), float(np.abs(got - want).max())


def test_import_rejects_wrong_architecture(pair):
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.models import UNet3D

    kmodel = pair[0]
    other = UNet3D(n_labels=1, depth=3, n_base_filters=2, deconvolution=True,
                   dtype=jnp.float32)
    variables = other.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)))
    with pytest.raises(ValueError, match="weight count mismatch"):
        import_keras_unet_weights(variables["params"],
                                  keras_weight_list_from_model(kmodel))


@pytest.fixture(scope="module")
def isensee_pair():
    """A tiny Keras Isensee2017 twin (GroupNormalization(groups=-1) ==
    keras-contrib InstanceNormalization) and our Isensee2017 with imported
    weights. Reference: training.py::load_old_model restores this
    architecture via custom_objects[InstanceNormalization]."""
    import jax
    import jax.numpy as jnp
    from keras import layers

    from fetal_mri_segmentation_tpu.models import Isensee2017
    from fetal_mri_segmentation_tpu.utils.keras_import import (
        import_keras_isensee_weights)

    depth, nbf, n_seg, shape = 3, 2, 2, (8, 8, 8)

    def conv_block(x, f, strides=1, kernel=3):
        x = layers.Conv3D(f, kernel, strides=strides, padding="same")(x)
        x = layers.GroupNormalization(groups=-1, epsilon=1e-3)(x)
        return layers.LeakyReLU(negative_slope=0.3)(x)

    inp = keras.Input(shape=shape + (1,))
    x = inp
    level_outputs, level_filters = [], []
    for level in range(depth):
        f = nbf * 2 ** level
        level_filters.append(f)
        in_conv = conv_block(x, f, strides=1 if level == 0 else 2)
        h = conv_block(in_conv, f)
        h = conv_block(h, f)
        x = layers.Add()([in_conv, h])
        level_outputs.append(x)

    seg_layers = []
    for level in range(depth - 2, -1, -1):
        f = level_filters[level]
        x = layers.UpSampling3D(2)(x)
        x = conv_block(x, f)
        x = layers.Concatenate()([level_outputs[level], x])
        x = conv_block(x, f)
        x = conv_block(x, f, kernel=1)
        if level < n_seg:
            seg_layers.insert(0, layers.Conv3D(1, 1)(x))

    out = None
    for level in reversed(range(n_seg)):
        out = seg_layers[level] if out is None else layers.Add()(
            [out, seg_layers[level]])
        if level > 0:
            out = layers.UpSampling3D(2)(out)
    out = layers.Activation("sigmoid")(out)
    kmodel = keras.Model(inp, out)

    fmodel = Isensee2017(n_labels=1, depth=depth, n_base_filters=nbf,
                         n_segmentation_levels=n_seg, dtype=jnp.float32)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape + (1,)))
    params = import_keras_isensee_weights(
        variables["params"], keras_weight_list_from_model(kmodel))
    return kmodel, fmodel, {"params": params}, shape


def test_isensee_forward_parity_with_keras(isensee_pair):
    kmodel, fmodel, variables, shape = isensee_pair
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2,) + shape + (1,)).astype(np.float32)
    want = np.asarray(kmodel(x))
    got = np.asarray(fmodel.apply(variables, x))
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=5e-5), float(np.abs(got - want).max())


def test_unet_importer_rejects_isensee(isensee_pair, pair):
    """An Isensee .h5 fed to the plain-UNet importer must fail loudly."""
    kmodel = isensee_pair[0]
    variables = pair[2]
    with pytest.raises(ValueError, match="normalization layers"):
        import_keras_unet_weights(variables["params"],
                                  keras_weight_list_from_model(kmodel))


def test_isensee_import_rejects_wrong_depth(isensee_pair):
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.models import Isensee2017
    from fetal_mri_segmentation_tpu.utils.keras_import import (
        import_keras_isensee_weights)

    kmodel = isensee_pair[0]
    other = Isensee2017(n_labels=1, depth=4, n_base_filters=2,
                        n_segmentation_levels=2, dtype=jnp.float32)
    variables = other.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)))
    with pytest.raises(ValueError, match="weight count mismatch"):
        import_keras_isensee_weights(variables["params"],
                                     keras_weight_list_from_model(kmodel))


def test_isensee_h5_roundtrip(isensee_pair, tmp_path):
    """Keras-3 .weights.h5 stores layers type-grouped (all convs, then all
    norms) — the importer must reconstruct the block/head pairing from the
    creation order and produce the same tree as importing the live model."""
    import jax

    from fetal_mri_segmentation_tpu.utils.keras_import import (
        import_keras_isensee_weights, keras_weight_list_from_h5)

    kmodel, fmodel, variables, shape = isensee_pair
    p = str(tmp_path / "isensee.weights.h5")
    kmodel.save_weights(p)
    from_file = import_keras_isensee_weights(variables["params"],
                                             keras_weight_list_from_h5(p))
    from_model = import_keras_isensee_weights(
        variables["params"], keras_weight_list_from_model(kmodel))
    for a, b in zip(jax.tree_util.tree_leaves(from_file),
                    jax.tree_util.tree_leaves(from_model)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_h5_roundtrip(pair, tmp_path):
    """Importing from a Keras-saved .h5 == importing from the live model."""
    import jax

    from fetal_mri_segmentation_tpu.utils.keras_import import (
        keras_weight_list_from_h5)

    kmodel, fmodel, variables, shape = pair
    p = str(tmp_path / "model.weights.h5")
    kmodel.save_weights(p)
    from_file = import_keras_unet_weights(variables["params"],
                                          keras_weight_list_from_h5(p))
    from_model = import_keras_unet_weights(
        variables["params"], keras_weight_list_from_model(kmodel))
    for a, b in zip(jax.tree_util.tree_leaves(from_file),
                    jax.tree_util.tree_leaves(from_model)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_export_unet_weights_forward_parity(pair):
    """EXPORT direction (utils/keras_export.py): random model weights pushed
    onto the twin Keras model must produce the same probabilities — the
    reverse-migration counterpart of the import parity test."""
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.models import UNet3D
    from fetal_mri_segmentation_tpu.utils.keras_export import (
        export_keras_unet_weights)

    kmodel, _, _, shape = pair
    fmodel = UNet3D(n_labels=1, depth=2, n_base_filters=2,
                    deconvolution=True, dtype=jnp.float32)
    variables = fmodel.init(jax.random.PRNGKey(42),
                            jnp.zeros((1,) + shape + (1,)))
    export_keras_unet_weights(variables["params"], kmodel)

    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2,) + shape + (1,)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, x))
    got = np.asarray(kmodel(x))
    assert np.allclose(got, want, atol=2e-5), float(np.abs(got - want).max())


def test_export_isensee_weights_forward_parity(isensee_pair):
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.models import Isensee2017
    from fetal_mri_segmentation_tpu.utils.keras_export import (
        export_keras_isensee_weights)

    kmodel, _, _, shape = isensee_pair
    fmodel = Isensee2017(n_labels=1, depth=3, n_base_filters=2,
                         n_segmentation_levels=2, dtype=jnp.float32)
    variables = fmodel.init(jax.random.PRNGKey(11),
                            jnp.zeros((1,) + shape + (1,)))
    export_keras_isensee_weights(variables["params"], kmodel)

    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2,) + shape + (1,)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, x, train=False))
    got = np.asarray(kmodel(x))
    assert np.allclose(got, want, atol=2e-5), float(np.abs(got - want).max())


def test_export_rejects_wrong_architecture(pair, isensee_pair):
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.models import UNet3D
    from fetal_mri_segmentation_tpu.utils.keras_export import (
        export_keras_unet_weights)

    kmodel_isensee = isensee_pair[0]
    fmodel = UNet3D(n_labels=1, depth=2, n_base_filters=2,
                    deconvolution=True, dtype=jnp.float32)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 8, 1)))
    with pytest.raises(ValueError, match="normalization"):
        export_keras_unet_weights(variables["params"], kmodel_isensee)
