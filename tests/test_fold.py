"""Exactness of the space-to-depth conv algebra (ops/fold.py).

Every folded formulation computes the SAME multiply-accumulates as the
unfolded op, reassociated — so in fp32 on CPU the results must match to
reassociation tolerance (~1e-5 relative), for every per-axis fold pattern
and every formulation. These are the equivalence contracts the round-5
perf probe (tools/probe_fold.py) and any model integration rest on.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fetal_mri_segmentation_tpu.ops.fold import (
    conv3_folded, conv3_folded_stride2, fold, pool_folded, unfold,
    up_conv3_folded)

DN = ("NDHWC", "DHWIO", "NDHWC")

FACTOR_SETS = [(2, 2, 2), (1, 2, 2), (2, 1, 1), (1, 1, 2)]


def _conv_same(x, k, b=None, strides=(1, 1, 1)):
    y = jax.lax.conv_general_dilated(x, k, strides, "SAME",
                                     dimension_numbers=DN)
    return y if b is None else y + b


def _rand(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.float32)


def test_fold_unfold_roundtrip(rng):
    x = _rand(rng, 2, 8, 6, 4, 3)
    for f in FACTOR_SETS:
        xf = fold(x, f)
        F = f[0] * f[1] * f[2]
        assert xf.shape == (2, 8 // f[0], 6 // f[1], 4 // f[2], 3 * F)
        np.testing.assert_array_equal(np.asarray(unfold(xf, f)),
                                      np.asarray(x))


def test_fold_order_is_subvoxel_major(rng):
    # channel layout must be ((b1*f2+b2)*f3+b3)*C + c
    x = _rand(rng, 1, 4, 4, 4, 2)
    xf = fold(x, (2, 2, 2))
    for b1, b2, b3 in itertools.product(range(2), repeat=3):
        s = (b1 * 2 + b2) * 2 + b3
        np.testing.assert_array_equal(
            np.asarray(xf[0, 1, 0, 1, s * 2:(s + 1) * 2]),
            np.asarray(x[0, 2 + b1, 0 + b2, 2 + b3]))


@pytest.mark.parametrize("factors", FACTOR_SETS)
@pytest.mark.parametrize("formulation", ["parity", "parity_batched", "dense"])
def test_conv3_folded_exact(rng, factors, formulation):
    cin, cout = 3, 5
    x = _rand(rng, 2, 8, 6, 4, cin)
    k = _rand(rng, 3, 3, 3, cin, cout) * 0.2
    b = _rand(rng, cout)
    want = _conv_same(x, k, b)
    got = unfold(conv3_folded(fold(x, factors), k, b, factors,
                              formulation=formulation), factors)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_conv3_folded_no_fold_is_plain_conv(rng):
    x = _rand(rng, 1, 4, 4, 4, 2)
    k = _rand(rng, 3, 3, 3, 2, 3)
    want = _conv_same(x, k)
    got = conv3_folded(x, k, None, (1, 1, 1))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("factors", FACTOR_SETS)
def test_conv3_folded_stride2_exact(rng, factors):
    cin, cout = 3, 4
    x = _rand(rng, 2, 8, 8, 8, cin)
    k = _rand(rng, 3, 3, 3, cin, cout) * 0.2
    b = _rand(rng, cout)
    want = _conv_same(x, k, b, strides=(2, 2, 2))
    got = conv3_folded_stride2(fold(x, factors), k, b, factors)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("factors", FACTOR_SETS)
def test_pool_folded_exact(rng, factors):
    x = _rand(rng, 2, 8, 6, 4, 3)
    want = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 2, 1), (1, 2, 2, 2, 1), "VALID")
    got = pool_folded(fold(x, factors), factors)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("factors", FACTOR_SETS)
def test_up_conv3_folded_exact(rng, factors):
    """conv3(upsample_nearest2(x)) == unfold(up_conv3_folded(x)).

    The output lives on the 2x grid; folded axes carry their parity in
    channels, unfolded axes interleave spatially — unfolding with the
    same factors must reproduce the plain upsample+conv (no bias here;
    the decoder adds it after the skip half).
    """
    from fetal_mri_segmentation_tpu.models.layers import upsample_nearest
    cin, cout = 3, 4
    x = _rand(rng, 2, 4, 3, 5, cin)
    k = _rand(rng, 3, 3, 3, cin, cout) * 0.2
    want = _conv_same(upsample_nearest(x, (2, 2, 2)), k)
    got = unfold(up_conv3_folded(x, k, factors), factors)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("formulation", ["parity", "parity_batched"])
def test_unet_fold_level0_matches_plain(rng, formulation):
    """UNet3D(fold_level0=(2,2,2)) == UNet3D() from the SAME params.

    The folded model is a pure reformulation: identical param tree
    (checkpoints interchange), identical function up to fp reassociation.
    """
    from fetal_mri_segmentation_tpu.models.unet3d import UNet3D

    x = _rand(rng, 1, 16, 16, 16, 1)
    plain = UNet3D(n_labels=2, depth=3, n_base_filters=4,
                   activation_name="sigmoid", dtype=jnp.float32)
    folded = UNet3D(n_labels=2, depth=3, n_base_filters=4,
                    activation_name="sigmoid", dtype=jnp.float32,
                    fold_level0=(2, 2, 2), fold_formulation=formulation)
    params = plain.init(jax.random.PRNGKey(0), x)
    fparams = folded.init(jax.random.PRNGKey(0), x)
    assert (jax.tree.structure(params) == jax.tree.structure(fparams)
            ), "folded model must keep the reference param tree"
    want = plain.apply(params, x)
    got = folded.apply(params, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    # logits path + partial fold too
    part = UNet3D(n_labels=2, depth=3, n_base_filters=4,
                  activation_name="sigmoid", dtype=jnp.float32,
                  fold_level0=(1, 2, 2), fold_formulation=formulation)
    np.testing.assert_allclose(
        np.asarray(part.apply(params, x, logits=True)),
        np.asarray(plain.apply(params, x, logits=True)),
        rtol=1e-4, atol=1e-5)


def test_unet_fold_level0_gates():
    from fetal_mri_segmentation_tpu.models.unet3d import UNet3D

    x = jnp.zeros((1, 8, 8, 8, 1), jnp.float32)
    with pytest.raises(ValueError, match="fused decoder"):
        UNet3D(depth=2, deconvolution=True,
               fold_level0=(2, 2, 2)).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="norm-free"):
        UNet3D(depth=2, batch_normalization=True,
               fold_level0=(2, 2, 2)).init(jax.random.PRNGKey(0), x)


def test_config_fold_wiring(rng):
    """Config.fold_level0 flows through build_model; validation rejects
    malformed factors/formulations at construction."""
    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model

    cfg = Config(model_name="unet", depth=3, n_base_filters=4,
                 fold_level0=[2, 2, 2], fold_formulation="parity_batched")
    m = build_model(cfg)
    assert m.fold_level0 == (2, 2, 2)
    assert m.fold_formulation == "parity_batched"
    with pytest.raises(ValueError, match="fold_level0"):
        Config(fold_level0=(2, 3, 2))
    with pytest.raises(ValueError, match="fold_formulation"):
        Config(fold_formulation="nope")


def test_unet_fold_auto_resolution(rng, monkeypatch):
    """"auto" folds only where the backend gate is open, falls back
    silently on gate failures, and a trace for another platform follows
    that platform's gate — all without changing the function value."""
    from fetal_mri_segmentation_tpu.models import layers as L
    from fetal_mri_segmentation_tpu.models.unet3d import UNet3D
    import fetal_mri_segmentation_tpu.ops.fold as fold_mod

    calls = []
    real = fold_mod.conv3_folded
    monkeypatch.setattr(fold_mod, "conv3_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    x = _rand(rng, 1, 8, 8, 8, 1)
    auto = UNet3D(n_labels=1, depth=2, n_base_filters=4, dtype=jnp.float32)
    assert auto.fold_level0 == "auto"
    params = auto.init(jax.random.PRNGKey(0), x)

    # gate closed on this suite's CPU backend: auto resolves to plain
    calls.clear()
    y_plain = auto.apply(params, x)
    assert not calls

    # gate opened for the CPU backend: auto resolves to FOLD_AUTO; same value
    monkeypatch.setattr(L, "FOLD_BACKENDS", frozenset({"cpu"}))
    calls.clear()
    y_fold = auto.apply(params, x)
    assert calls, "auto should engage the folded path when the gate passes"
    np.testing.assert_allclose(np.asarray(y_fold), np.asarray(y_plain),
                               rtol=1e-4, atol=1e-5)

    # a trace for a platform whose gate is closed does not fold
    calls.clear()
    with L.trace_for_platforms(["cuda", "cpu"]):
        y_off = auto.apply(params, x)
    assert not calls
    np.testing.assert_array_equal(np.asarray(y_off), np.asarray(y_plain))

    # norms on: auto falls back instead of raising
    bn = UNet3D(n_labels=1, depth=2, n_base_filters=4,
                batch_normalization=True, dtype=jnp.float32)
    vs = bn.init(jax.random.PRNGKey(0), x)
    calls.clear()
    bn.apply(vs, x)
    assert not calls


def test_dp_step_matches_single_device_with_fold():
    """Folding under shard_map data parallelism: the 8-shard DP step with
    an EXPLICIT fold (the CPU auto-gate would turn it off) matches the
    single-device folded step — the path a multi-device run takes when the auto
    default engages inside DP training."""
    import optax

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel.data_parallel import (
        make_dp_train_step, make_mesh, replicate_state, shard_batch)
    from fetal_mri_segmentation_tpu.training.state import create_train_state
    from fetal_mri_segmentation_tpu.training.train_step import make_train_step

    cfg = Config(model_name="unet", depth=2, n_base_filters=4,
                 patch_shape=(8, 8, 8), batch_size=8,
                 compute_dtype="float32", augment=False,
                 initial_learning_rate=1e-2,
                 fold_level0=(1, 1, 2), fold_formulation="dense")
    model = build_model(cfg)
    rng0 = np.random.default_rng(0)
    y = np.zeros((8, 1, 8, 8, 8), np.float32)
    y[:, :, 2:6, 2:6, 2:6] = 1.0
    x = (y * 2 + rng0.normal(0, 0.3, y.shape)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    tx = optax.sgd(1.0)

    state1 = create_train_state(model, cfg, jax.random.PRNGKey(0), tx=tx)
    new1, m1 = make_train_step(model, cfg)(
        state1, jnp.asarray(x), jnp.asarray(y), rng, 8)

    mesh = make_mesh(8)
    state8 = replicate_state(mesh, create_train_state(
        model, cfg, jax.random.PRNGKey(0), tx=tx))
    xs, ys = shard_batch(mesh, x, y)
    new8, m8 = make_dp_train_step(model, cfg, mesh)(
        state8, xs, ys, rng, jnp.asarray(8))

    assert np.allclose(float(m1["loss"]), float(m8["loss"]), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(new1.params),
                    jax.tree_util.tree_leaves(new8.params)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_isensee_fold_level0_matches_plain(rng, train):
    """Isensee2017(fold_level0) == plain from the SAME params — including
    InstanceNorm (folded moments over spatial x sub-voxel), the stride-2
    entry consuming folded input, folded concat/upsample, per-sub-voxel
    1^3 localization and seg heads, and (train=True) identical
    SpatialDropout rng consumption."""
    from fetal_mri_segmentation_tpu.models.isensee2017 import Isensee2017

    x = _rand(rng, 1, 16, 16, 16, 1)
    kw = dict(n_labels=2, depth=3, n_base_filters=4,
              n_segmentation_levels=2, dtype=jnp.float32)
    plain = Isensee2017(fold_level0="off", **kw)
    folded = Isensee2017(fold_level0=(1, 1, 2), fold_formulation="dense",
                         **kw)
    params = plain.init(jax.random.PRNGKey(0), x)
    fparams = folded.init(jax.random.PRNGKey(0), x)
    assert jax.tree.structure(params) == jax.tree.structure(fparams)
    rngs = {"dropout": jax.random.PRNGKey(3)} if train else {}
    want = plain.apply(params, x, train=train, rngs=rngs)
    got = folded.apply(params, x, train=train, rngs=rngs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


def test_isensee_fold_full_factors(rng):
    # full 2^3 fold exercises every folded axis in concat/upsample/seg
    from fetal_mri_segmentation_tpu.models.isensee2017 import Isensee2017

    x = _rand(rng, 1, 8, 8, 8, 1)
    kw = dict(n_labels=1, depth=2, n_base_filters=4,
              n_segmentation_levels=1, dtype=jnp.float32)
    plain = Isensee2017(fold_level0="off", **kw)
    folded = Isensee2017(fold_level0=(2, 2, 2), fold_formulation="parity",
                         **kw)
    params = plain.init(jax.random.PRNGKey(1), x)
    np.testing.assert_allclose(
        np.asarray(folded.apply(params, x, logits=True)),
        np.asarray(plain.apply(params, x, logits=True)),
        rtol=2e-4, atol=2e-5)


def test_spatial_predictor_matches_single_device_with_fold():
    """Folding composes with GSPMD depth-axis sharding: the spatially
    sharded whole-volume predictor with an EXPLICIT fold (the CPU auto
    gate would turn it off) equals the unsharded folded forward — the
    combination a multi-device run takes when auto-fold engages inside
    parallel/spatial.py's halo-exchange predictor. Fold (1,1,2) folds W
    while the mesh shards D, so the halo exchange and the fold touch
    different axes."""
    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel import (
        make_hybrid_mesh, make_spatial_predictor)
    from fetal_mri_segmentation_tpu.training import create_train_state

    cfg = Config(model_name="unet", depth=2, n_base_filters=2,
                 patch_shape=(16, 16, 16), batch_size=2,
                 compute_dtype="float32", augment=False,
                 fold_level0=(1, 1, 2), fold_formulation="dense")
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    variables = {"params": state.params}
    vol = np.random.default_rng(7).normal(
        0, 1, (1, 32, 16, 16)).astype(np.float32)

    x = jnp.transpose(jnp.asarray(vol), (1, 2, 3, 0))[None]
    want = np.transpose(np.asarray(model.apply(variables, x))[0],
                        (3, 0, 1, 2))

    mesh = make_hybrid_mesh(1, 8)
    predict = make_spatial_predictor(model, cfg, mesh)
    got = predict(variables, vol)
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=1e-5), \
        float(np.abs(got - want).max())


def test_unet_fold_non_cubic_patch(rng, monkeypatch):
    """Fetal volumes are non-cubic; the folded model must agree with the
    plain one on non-cubic patches, and "auto" must fall back (not fold)
    for batched programs — the reachable fallback gate."""
    from fetal_mri_segmentation_tpu.models import layers as L
    from fetal_mri_segmentation_tpu.models.unet3d import UNet3D
    from fetal_mri_segmentation_tpu.ops import fold as fold_mod

    x = _rand(rng, 1, 8, 12, 6, 1)
    plain = UNet3D(n_labels=1, depth=2, n_base_filters=4,
                   dtype=jnp.float32, fold_level0="off")
    folded = UNet3D(n_labels=1, depth=2, n_base_filters=4,
                    dtype=jnp.float32, fold_level0=(1, 1, 2),
                    fold_formulation="dense")
    params = plain.init(jax.random.PRNGKey(0), x)
    np.testing.assert_allclose(np.asarray(folded.apply(params, x)),
                               np.asarray(plain.apply(params, x)),
                               rtol=1e-4, atol=1e-5)

    # auto fallback at batch > 1: even with the backend gate open the
    # auto model must take the plain path
    monkeypatch.setattr(L, "FOLD_BACKENDS", frozenset({"cpu"}))
    calls = []
    real = fold_mod.conv3_folded
    monkeypatch.setattr(fold_mod, "conv3_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    auto = UNet3D(n_labels=1, depth=2, n_base_filters=4, dtype=jnp.float32)
    xb = _rand(rng, 2, 8, 12, 6, 1)
    pb = auto.init(jax.random.PRNGKey(0), xb)
    calls.clear()
    auto.apply(pb, xb)
    assert not calls, "auto must not fold batched programs"
    # ...and at batch 1 with the same config it folds
    calls.clear()
    auto.apply(pb, xb[:1])
    assert calls


def test_conv3_folded_stride2_rejects_odd_unfolded_axis(rng):
    """SAME stride-2 pads odd axes (1,1), not the (0,1) this routing
    encodes — the op must refuse rather than silently diverge."""
    x = _rand(rng, 1, 7, 8, 8, 2)  # D=7 odd, unfolded under (1,1,2)
    k = _rand(rng, 3, 3, 3, 2, 3)
    with pytest.raises(ValueError, match="even spatial"):
        conv3_folded_stride2(fold(x, (1, 1, 2)), k, None, (1, 1, 2))


def test_unet_fold_depth4(rng):
    """The serve config's depth-4 geometry: fold only ever touches level
    0, but pin the deeper-skip channel bookkeeping too."""
    from fetal_mri_segmentation_tpu.models.unet3d import UNet3D

    x = _rand(rng, 1, 16, 16, 16, 1)
    plain = UNet3D(n_labels=1, depth=4, n_base_filters=2,
                   dtype=jnp.float32, fold_level0="off")
    folded = UNet3D(n_labels=1, depth=4, n_base_filters=2,
                    dtype=jnp.float32, fold_level0=(1, 1, 2),
                    fold_formulation="dense")
    params = plain.init(jax.random.PRNGKey(0), x)
    np.testing.assert_allclose(np.asarray(folded.apply(params, x)),
                               np.asarray(plain.apply(params, x)),
                               rtol=1e-4, atol=1e-5)
