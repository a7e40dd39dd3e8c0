"""The in-repo module system (models/nn.py) against Flax linen, where
linen is installed: the same model code built on either gives the same
parameter tree (names, shapes, dtypes) and, on shared parameters, the
same deterministic outputs. Plus the module system's own contracts."""

import importlib
import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from triad.models import nn

_MODEL_MODULES = (
    "triad.models.layers", "triad.models.vit",
    "triad.models.hubert", "triad.models.distilbert",
    "triad.models.multimodal",
)


def _linen_shim():
    linen = pytest.importorskip("flax.linen")
    from flax import traverse_util

    shim = types.ModuleType("triad.models.nn")
    for name in nn.__all__:
        if hasattr(linen, name):
            setattr(shim, name, getattr(linen, name))
    shim.flatten_dict = traverse_util.flatten_dict
    shim.unflatten_dict = traverse_util.unflatten_dict
    shim.map_variables = lambda cls, fn: linen.map_variables(
        cls, "params", trans_in_fn=fn, trans_out_fn=lambda x: x,
        init=True, mutable=True,
    )
    return shim


@pytest.fixture(scope="module")
def linen_models():
    """Fresh copies of the model modules whose ``nn`` is Flax linen."""
    shim = _linen_shim()
    saved = {m: sys.modules.pop(m) for m in ("triad.models.nn",)
             + _MODEL_MODULES}
    sys.modules["triad.models.nn"] = shim
    try:
        mods = {m.rsplit(".", 1)[1]: importlib.import_module(m)
                for m in _MODEL_MODULES}
    finally:
        for m in ("triad.models.nn",) + _MODEL_MODULES:
            sys.modules.pop(m, None)
        sys.modules.update(saved)
    return mods


def _small_cfg():
    from tests.test_multimodal import small_model_config

    return small_model_config()


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "images": jnp.asarray(rng.normal(size=(2, 28, 28, 3)), jnp.float32),
        "audio": jnp.asarray(rng.normal(size=(2, 1600)), jnp.float32),
        "ids": jnp.asarray(rng.integers(1, 100, size=(2, 8))),
        "mask": jnp.asarray([[1] * 8, [1] * 5 + [0] * 3], jnp.float32),
    }


def _build(mods, which, remat="chunked_conv"):
    import dataclasses

    cfg = _small_cfg()
    cfg = dataclasses.replace(
        cfg, hubert=dataclasses.replace(cfg.hubert, remat=remat)
    )
    x = _inputs()
    if which == "vit":
        return mods["vit"].DinoViT(cfg.vit), (x["images"],)
    if which == "hubert":
        return mods["hubert"].HubertModel(cfg.hubert), (x["audio"],)
    if which == "text":
        return (mods["distilbert"].DistilBertModel(cfg.text),
                (x["ids"], x["mask"]))
    return (mods["multimodal"].TriadModel(cfg),
            (x["images"], x["audio"], x["ids"], x["mask"]))


def _ours():
    return {m.rsplit(".", 1)[1]: importlib.import_module(m)
            for m in _MODEL_MODULES}


@pytest.mark.parametrize("which,remat", [
    ("vit", "chunked_conv"), ("hubert", "chunked_conv"), ("hubert", "none"),
    ("hubert", "conv"), ("hubert", "full"), ("text", "chunked_conv"),
    ("triad", "chunked_conv"),
])
def test_same_tree_and_outputs_as_linen(linen_models, which, remat):
    ref_model, args = _build(linen_models, which, remat)
    our_model, _ = _build(_ours(), which, remat)
    ref_params = ref_model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, *args
    )["params"]
    our_params = our_model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, *args
    )["params"]
    spec = lambda t: jax.tree.map(lambda a: (a.shape, a.dtype), t)
    assert spec(our_params) == spec(ref_params)
    want = ref_model.apply({"params": ref_params}, *args)
    got = our_model.apply({"params": ref_params}, *args)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_gradients_match_linen_through_remat_and_frozen_vit(linen_models):
    """Training-mode gradients with dropout off: remat'd HuBERT layers
    and the map_variables-frozen ViT base (no grads but LoRA)."""
    import dataclasses

    cfg = _small_cfg()
    cfg = dataclasses.replace(
        cfg,
        hubert=dataclasses.replace(
            cfg.hubert, remat="full", hidden_dropout=0.0,
            activation_dropout=0.0, attention_dropout=0.0, layerdrop=0.0,
            mask_time_prob=0.0,
        ),
        text=dataclasses.replace(cfg.text, dropout=0.0, attention_dropout=0.0),
        visual_dropout_prob=0.0,
    )
    x = _inputs()
    args = (x["images"], x["audio"], x["ids"], x["mask"])
    ref = linen_models["multimodal"].TriadModel(cfg)
    ours = _ours()["multimodal"].TriadModel(cfg)
    params = ref.init(jax.random.key(0), *args)["params"]

    def loss(model):
        def f(p):
            out = model.apply({"params": p}, *args, train=True,
                              rngs={"dropout": jax.random.key(2)})
            return sum(jnp.sum(v ** 2) for v in out.values())
        return f

    g_ref = jax.grad(loss(ref))(params)
    g_our = jax.grad(loss(ours))(params)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(g_ref),
                            jax.tree.leaves(g_our)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=jax.tree_util.keystr(path))
    vit = g_our["visual_backbone"]["block_0"]["attn"]["qkv"]
    assert float(jnp.abs(vit["kernel"]).max()) == 0.0


@pytest.mark.parametrize("layer,x_shape", [
    (lambda m: m.Dense(5, dtype=jnp.bfloat16), (3, 4, 7)),
    (lambda m: m.Conv(6, kernel_size=(3,), strides=(2,), padding="VALID"),
     (2, 11, 4)),
    (lambda m: m.Conv(8, kernel_size=(5,), padding=[(2, 2)],
                      feature_group_count=4), (2, 9, 8)),
    (lambda m: m.Conv(4, kernel_size=(2, 2), strides=(2, 2),
                      padding="VALID"), (1, 6, 6, 3)),
    (lambda m: m.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16), (2, 5, 16)),
])
def test_layers_match_linen(layer, x_shape):
    linen = pytest.importorskip("flax.linen")
    x = jnp.asarray(np.random.default_rng(0).normal(size=x_shape),
                    jnp.float32)
    ref, ours = layer(linen), layer(nn)
    params = ref.init(jax.random.key(0), x)["params"]
    assert jax.tree.structure(ours.init(jax.random.key(0), x)["params"]) \
        == jax.tree.structure(params)
    want = ref.apply({"params": params}, x)
    got = ours.apply({"params": params}, x)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=1e-6)


class _Net(nn.Module):
    features: int = 3

    @nn.compact
    def __call__(self, x, deterministic=True):
        x = nn.Dense(self.features)(x)
        x = nn.Dropout(0.5)(x, deterministic)
        return nn.Dense(self.features, name="head")(nn.Dense(4)(x))


def test_autonames_and_empty_subtrees():
    params = _Net().init(jax.random.key(0), jnp.ones((2, 3)))["params"]
    assert set(params) == {"Dense_0", "Dense_1", "head"}


def test_apply_errors():
    params = _Net().init(jax.random.key(0), jnp.ones((2, 3)))["params"]
    del params["head"]
    with pytest.raises(KeyError, match="head/kernel"):
        _Net().apply({"params": params}, jnp.ones((2, 3)))
    full = _Net().init(jax.random.key(0), jnp.ones((2, 3)))["params"]
    with pytest.raises(ValueError, match="dropout"):
        _Net().apply({"params": full}, jnp.ones((2, 3)), False)


def test_dropout_streams_differ_per_call_and_key():
    params = _Net().init(jax.random.key(0), jnp.ones((2, 3)))["params"]
    run = lambda k: _Net().apply({"params": params}, jnp.ones((64, 3)),
                                 False, rngs={"dropout": jax.random.key(k)})
    np.testing.assert_array_equal(np.asarray(run(1)), np.asarray(run(1)))
    assert not np.allclose(np.asarray(run(1)), np.asarray(run(2)))


def test_intercept_methods_wraps_calls():
    seen = []

    def spy(next_fn, args, kwargs, context):
        seen.append((type(context.module).__name__, context.method_name))
        return next_fn(*args, **kwargs)

    params = _Net().init(jax.random.key(0), jnp.ones((2, 3)))["params"]
    with nn.intercept_methods(spy):
        _Net().apply({"params": params}, jnp.ones((2, 3)))
    assert ("Dense", "__call__") in seen and ("_Net", "__call__") in seen
    seen.clear()
    _Net().apply({"params": params}, jnp.ones((2, 3)))
    assert not seen


def test_flatten_unflatten_roundtrip():
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    flat = nn.flatten_dict(tree)
    assert flat == {("a", "b"): 1, ("a", "c", "d"): 2, ("e",): 3}
    assert nn.unflatten_dict(flat) == tree
