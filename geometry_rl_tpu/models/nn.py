"""A small module layer for the policy and value networks.

It keeps the `Module`/`compact` programming model that the models are written
in, and the parameter trees and initial values it produces are those of the
Flax linen API the models were first written against: submodules are named
`<Class>_<n>` per class unless named explicitly, modules passed as fields are
named after the field, and parameter keys are derived from the root key by
folding in the SHA-1 hash of the module path and a per-module counter. So
checkpointed parameter trees and seeded initialisations keep their names and
values.

Only what the models use is here: `Module`, `compact`, `param`, `sow`,
`make_rng`, `init`/`apply` with `rngs` and `mutable`, and the layers `Dense`,
`DenseGeneral`, `LayerNorm`, `Dropout`, `Sequential` and
`MultiHeadDotProductAttention`.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import elu, gelu, initializers, one_hot, relu, silu, softplus  # noqa: F401
from jax.numpy import tanh  # noqa: F401

_UNSPECIFIED = object()
_CONTEXT: list = []  # modules whose compact method is running, innermost last


def _fold_in_path(key: jax.Array, path: Tuple, count: int) -> jax.Array:
    """Fold a module path and a counter into `key` (one SHA-1, first 4 bytes)."""
    m = hashlib.sha1()
    for x in path + (count,):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4], byteorder="big")))


class _Frame:
    """State of one `init` or `apply` call: variables, rngs, mutability."""

    def __init__(self, variables, rngs, mutable):
        self.variables = {col: _copy_tree(tree) for col, tree in variables.items()}
        self.rngs = rngs
        self.mutable = mutable
        self.rng_counters: dict = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


class _Scope:
    def __init__(self, frame: _Frame, path: Tuple[str, ...]):
        self.frame = frame
        self.path = path

    def child(self, name: str) -> "_Scope":
        return _Scope(self.frame, self.path + (name,))

    def _node(self, col: str, create: bool):
        node = self.frame.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.frame.variables[col] = {}
        for p in self.path:
            nxt = node.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = node[p] = {}
            node = nxt
        return node

    def make_rng(self, name: str) -> jax.Array:
        rngs = self.frame.rngs
        if name not in rngs:
            if "params" not in rngs:
                raise ValueError(f"module {'/'.join(self.path)} needs an rng named {name!r}")
            name = "params"
        counters = self.frame.rng_counters.setdefault(self.path, {})
        counters[name] = counters.get(name, 0) + 1
        return _fold_in_path(rngs[name], self.path, counters[name])

    def param(self, name: str, init_fn: Callable, *init_args):
        node = self._node("params", create=False)
        if node is not None and name in node:
            return node[name]
        if not self.frame.is_mutable("params"):
            raise ValueError(f"parameter {'/'.join(self.path + (name,))} is missing")
        value = init_fn(self.make_rng("params"), *init_args)
        self._node("params", create=True)[name] = value
        return value

    def sow(self, col: str, name: str, value) -> bool:
        if not self.frame.is_mutable(col):
            return False
        node = self._node(col, create=True)
        node[name] = node.get(name, ()) + (value,)
        return True


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class: subclasses are dataclasses whose fields are hyperparameters.

    A module built while another module's `compact` method runs becomes that
    module's child; one built elsewhere is bound by `init`/`apply`, or by the
    module that holds it as a field.
    """

    parent: Any = dataclasses.field(default=_UNSPECIFIED, kw_only=True, repr=False)
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False, repr=False)

    def __post_init__(self):
        self._scope = None
        self._cursor = {}
        if self.parent is _UNSPECIFIED:
            self.parent = _CONTEXT[-1] if _CONTEXT else None
        if self.parent is None:
            return
        if self.name is None:
            prefix = type(self).__name__
            n = self.parent._cursor.get(prefix, 0)
            self.parent._cursor[prefix] = n + 1
            self.name = f"{prefix}_{n}"
        self._bind(self.parent._scope.child(self.name))

    def _bind(self, scope: _Scope) -> None:
        """Attach to `scope` and adopt unbound submodules held in fields."""
        self._scope = scope
        for f in dataclasses.fields(self):
            if f.name in ("parent", "name"):
                continue
            value = getattr(self, f.name)
            if isinstance(value, Module) and value.parent is None:
                setattr(self, f.name, dataclasses.replace(value, parent=self, name=f.name))
            elif isinstance(value, (list, tuple)) and any(
                isinstance(v, Module) and v.parent is None for v in value
            ):
                adopted = [
                    dataclasses.replace(v, parent=self, name=f"{f.name}_{i}")
                    if isinstance(v, Module) and v.parent is None
                    else v
                    for i, v in enumerate(value)
                ]
                setattr(self, f.name, type(value)(adopted))

    # -- inside a bound module ------------------------------------------------

    def param(self, name: str, init_fn: Callable, *init_args):
        return self._scope.param(name, init_fn, *init_args)

    def sow(self, col: str, name: str, value) -> bool:
        return self._scope.sow(col, name, value)

    def make_rng(self, name: str = "params") -> jax.Array:
        return self._scope.make_rng(name)

    # -- entry points ---------------------------------------------------------

    def _run(self, variables, rngs, mutable, method, args, kwargs):
        if rngs is not None and not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame(variables, rngs or {}, mutable)
        root = dataclasses.replace(self, parent=None)
        root._bind(_Scope(frame, ()))
        fn = method if method is not None else type(root).__call__
        out = fn(root, *args, **kwargs)
        return out, frame

    def init(self, rngs, *args, method: Optional[Callable] = None, **kwargs):
        """Initialise every collection; returns the variables dict."""
        _, frame = self._run({}, rngs, True, method, args, kwargs)
        return frame.variables

    def apply(self, variables, *args, rngs=None, mutable=False, method: Optional[Callable] = None, **kwargs):
        """Run with `variables`; with `mutable`, also return the updated
        mutable collections."""
        mutable = tuple(mutable) if isinstance(mutable, (list, tuple)) else mutable
        out, frame = self._run(variables, rngs, mutable or (), method, args, kwargs)
        if not mutable:
            return out
        return out, {col: tree for col, tree in frame.variables.items() if frame.is_mutable(col)}


def compact(fn: Callable) -> Callable:
    """Let `fn` build submodules inline; they are named afresh on every call,
    so repeated calls reuse the same parameters."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            raise RuntimeError(f"{type(self).__name__} is not bound: call it through init/apply")
        self._cursor = {}
        _CONTEXT.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            _CONTEXT.pop()

    return wrapped


def _promote_dtype(*args, dtype=None):
    if dtype is None:
        dtype = jnp.result_type(*[a for a in args if a is not None])
        if not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


_default_kernel_init = initializers.lecun_normal()


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init, (jnp.shape(x)[-1], self.features), self.param_dtype)
        bias = self.param("bias", self.bias_init, (self.features,), self.param_dtype) if self.use_bias else None
        x, kernel, bias = _promote_dtype(x, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())), precision=self.precision)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class DenseGeneral(Module):
    """Dense over the trailing `axis` dims, with a tuple of output `features`.
    Parameters are initialised in their flattened 2-D shape."""

    features: Tuple[int, ...]
    axis: Tuple[int, ...] = (-1,)
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        features = tuple(self.features)
        axis = tuple(a % x.ndim for a in self.axis)
        in_shape = tuple(x.shape[a] for a in axis)
        n_in = 1
        for s in in_shape:
            n_in *= s
        n_out = 1
        for s in features:
            n_out *= s

        def kernel_init(rng, shape, dtype):
            return jnp.reshape(self.kernel_init(rng, (n_in, n_out), dtype), shape)

        def bias_init(rng, shape, dtype):
            return jnp.reshape(self.bias_init(rng, (n_out,), dtype), shape)

        kernel = self.param("kernel", kernel_init, in_shape + features, self.param_dtype)
        bias = self.param("bias", bias_init, features, self.param_dtype) if self.use_bias else None
        x, kernel, bias = _promote_dtype(x, kernel, bias, dtype=self.dtype)
        contract = (axis, tuple(range(len(axis))))
        y = lax.dot_general(x, kernel, (contract, ((), ())), precision=self.precision)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - len(features)) + features)
        return y


class LayerNorm(Module):
    """Layer normalisation over the last axis; statistics in float32."""

    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x):
        stat_dtype = jnp.promote_types(self.dtype or jnp.result_type(x), jnp.float32)
        xf = x.astype(stat_dtype)
        mean = xf.mean(-1, keepdims=True)
        var = jnp.maximum(0.0, (xf * xf).mean(-1, keepdims=True) - mean * mean)
        y = x - mean
        mul = lax.rsqrt(var + self.epsilon)
        args = [x]
        features = (x.shape[-1],)
        if self.use_scale:
            scale = self.param("scale", self.scale_init, features, self.param_dtype)
            mul *= scale
            args.append(scale)
        y *= mul
        if self.use_bias:
            bias = self.param("bias", self.bias_init, features, self.param_dtype)
            y += bias
            args.append(bias)
        dtype = self.dtype if self.dtype is not None else jnp.result_type(*args)
        return jnp.asarray(y, dtype)


class Dropout(Module):
    rate: float
    deterministic: Optional[bool] = None

    @compact
    def __call__(self, x, deterministic: Optional[bool] = None):
        deterministic = self.deterministic if deterministic is None else deterministic
        if self.rate == 0.0 or deterministic:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep_prob = 1.0 - self.rate
        keep = jax.random.bernoulli(self.make_rng("dropout"), p=keep_prob, shape=x.shape)
        return lax.select(keep, x / keep_prob, jnp.zeros_like(x))


class Sequential(Module):
    layers: Sequence[Callable]

    def __call__(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MultiHeadDotProductAttention(Module):
    num_heads: int
    dtype: Any = None
    param_dtype: Any = jnp.float32
    qkv_features: Optional[int] = None
    out_features: Optional[int] = None
    broadcast_dropout: bool = True
    dropout_rate: float = 0.0
    deterministic: Optional[bool] = None
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros
    use_bias: bool = True
    precision: Any = None

    @compact
    def __call__(self, inputs_q, inputs_k=None, inputs_v=None, *, mask=None, deterministic: Optional[bool] = None):
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v
        features = self.out_features or inputs_q.shape[-1]
        qkv_features = self.qkv_features or inputs_q.shape[-1]
        head_dim = qkv_features // self.num_heads
        dense = functools.partial(
            DenseGeneral,
            features=(self.num_heads, head_dim),
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            kernel_init=self.kernel_init,
            bias_init=self.bias_init,
            use_bias=self.use_bias,
            precision=self.precision,
        )
        query = dense(name="query")(inputs_q)
        key = dense(name="key")(inputs_k)
        value = dense(name="value")(inputs_v)

        deterministic = self.deterministic if deterministic is None else deterministic
        dropout = self.dropout_rate > 0.0 and not deterministic
        dropout_rng = self.make_rng("dropout") if dropout else None

        query, key = _promote_dtype(query, key, dtype=self.dtype)
        dtype = query.dtype
        query = query / jnp.sqrt(query.shape[-1]).astype(dtype)
        weights = jnp.einsum("...qhd,...khd->...hqk", query, key, precision=self.precision)
        if mask is not None:
            weights = jnp.where(mask, weights, jnp.finfo(dtype).min)
        weights = jax.nn.softmax(weights).astype(dtype)
        if dropout:
            keep_prob = 1.0 - self.dropout_rate
            shape = (1,) * (key.ndim - 2) + weights.shape[-2:] if self.broadcast_dropout else weights.shape
            keep = jax.random.bernoulli(dropout_rng, keep_prob, shape)
            weights = weights * (keep.astype(dtype) / jnp.asarray(keep_prob, dtype=dtype))
        x = jnp.einsum("...hqk,...khd->...qhd", weights, value, precision=self.precision)
        return DenseGeneral(
            features=(features,),
            axis=(-2, -1),
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            kernel_init=self.kernel_init,
            bias_init=self.bias_init,
            use_bias=self.use_bias,
            precision=self.precision,
            name="out",
        )(x)
