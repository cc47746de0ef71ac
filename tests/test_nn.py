"""The in-repo module layer (models/nn.py): naming, sharing, collections
and the layers the models use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometry_rl_tpu.models import nn


class _Block(nn.Module):
    features: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(self.features, dtype=self.dtype)(x)
        x = nn.LayerNorm(dtype=self.dtype)(x)
        self.sow("stats", "mean", x.mean())
        return nn.Dense(self.features, name="out")(nn.relu(x))


class _Net(nn.Module):
    inner: nn.Module
    layers: tuple = ()

    @nn.compact
    def __call__(self, x):
        shared = _Block(4, name="shared")
        h = shared(x) + shared(x)  # one parameter set, used twice
        h = self.inner(h)
        for layer in self.layers:
            h = layer(h)
        return nn.Sequential([nn.Dense(3), nn.relu, nn.Dense(2)])(h)


def _net():
    return _Net(inner=_Block(4), layers=(nn.Dense(4), nn.Dense(4)))


def test_param_tree_names():
    params = _net().init(jax.random.PRNGKey(0), jnp.ones((2, 5)))["params"]
    assert sorted(params) == ["Dense_0", "Dense_1", "inner", "layers_0", "layers_1", "shared"]
    assert sorted(params["shared"]) == ["Dense_0", "LayerNorm_0", "out"]
    assert sorted(params["shared"]["LayerNorm_0"]) == ["bias", "scale"]
    assert params["shared"]["Dense_0"]["kernel"].shape == (5, 4)
    assert params["Dense_1"]["kernel"].shape == (3, 2)


def test_init_is_seeded_and_keys_differ_per_path():
    x = jnp.ones((2, 5))
    a = _net().init(jax.random.PRNGKey(0), x)["params"]
    b = _net().init(jax.random.PRNGKey(0), x)["params"]
    c = _net().init(jax.random.PRNGKey(1), x)["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    assert not np.array_equal(a["layers_0"]["kernel"], c["layers_0"]["kernel"])
    assert not np.array_equal(a["layers_0"]["kernel"], a["layers_1"]["kernel"])


def test_apply_reuses_params_and_returns_mutable_collections():
    net, x = _net(), jnp.linspace(-1, 1, 10).reshape(2, 5)
    variables = net.init(jax.random.PRNGKey(0), x)
    assert "stats" in variables  # init makes every collection
    y = net.apply({"params": variables["params"]}, x)
    y2, cols = net.apply({"params": variables["params"]}, x, mutable=["stats"])
    np.testing.assert_array_equal(y, y2)
    assert len(cols["stats"]["shared"]["mean"]) == 2  # sown on both calls
    with pytest.raises(ValueError, match="missing"):
        net.apply({"params": {}}, x)


def test_layer_norm_matches_formula():
    x = jax.random.normal(jax.random.PRNGKey(2), (3, 7)) * 3 + 1
    ln = nn.LayerNorm()
    v = ln.init(jax.random.PRNGKey(0), x)
    want = (x - x.mean(-1, keepdims=True)) / jnp.sqrt(x.var(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(ln.apply(v, x), want, rtol=1e-5, atol=1e-5)
    y16 = nn.LayerNorm(dtype=jnp.bfloat16).apply(v, x.astype(jnp.bfloat16))
    assert y16.dtype == jnp.bfloat16


def test_dense_dtype_and_precision_follow_inputs():
    d = nn.Dense(3)
    v = d.init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
    assert d.apply(v, jnp.ones((2, 4), jnp.bfloat16)).dtype == jnp.float32  # promoted with f32 params
    assert nn.Dense(3, dtype=jnp.bfloat16).apply(v, jnp.ones((2, 4))).dtype == jnp.bfloat16


def test_attention_masks_keys_and_dropout_needs_rng():
    x = jax.random.normal(jax.random.PRNGKey(3), (2, 5, 8))
    attn = nn.MultiHeadDotProductAttention(num_heads=2, dropout_rate=0.5)
    v = attn.init(jax.random.PRNGKey(0), x, x)
    assert v["params"]["query"]["kernel"].shape == (8, 2, 4)
    assert v["params"]["out"]["kernel"].shape == (2, 4, 8)
    mask = jnp.arange(5)[None, None, None, :] < 3
    y = attn.apply(v, x, x, mask=mask, deterministic=True)
    # the masked keys (3, 4) do not influence any output
    x2 = x.at[:, 3:].set(100.0)
    y2 = attn.apply(v, x2, x2, mask=mask, deterministic=True)
    np.testing.assert_allclose(y[:, :3], y2[:, :3], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="rng"):
        attn.apply(v, x, x, deterministic=False)
    yd = attn.apply(v, x, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
    assert yd.shape == y.shape and not np.allclose(yd, y)
