"""A small module system: the part of Flax linen's API the encoders use.

Modules are dataclasses. A module's parameters live in a nested dict
keyed by submodule names, laid out exactly as linen lays them out
(``{"params": {"layer_0": {"attention": {"q_proj": {"kernel": ...}}}}}``),
so weight porting (models/hf_import.py, models/reference_import.py),
the TP/FSDP partition rules (parallel/tp.py) and saved checkpoints see
the same tree whichever system built it.

What is here, and nothing more:

- ``Module`` with ``@compact`` and ``setup``, ``param``, ``make_rng``,
  ``get_variable``, ``init`` and ``apply`` (``method=`` a function or
  a method name, ``rngs=`` a dict of PRNG keys);
- ``Dense``, ``Conv``, ``LayerNorm`` and ``Dropout``, numerically the
  linen layers of the same names;
- ``remat``/``checkpoint`` over a module class or a function that takes
  a module first, ``map_variables`` for the frozen ViT base,
  ``intercept_methods`` for int8 serving, and ``flatten_dict`` /
  ``unflatten_dict``.

A submodule is bound to its parent when it is constructed inside the
parent's ``@compact`` method or ``setup``. Its name is the ``name=``
argument, or ``<ClassName>_<n>`` counted per class within one call of
the parent. Parameters are created on ``init`` from the ``"params"``
key folded with the module path and the parameter name, and must exist
on ``apply``. Random streams (``make_rng``) fold the module path and a
per-call counter into the key of that stream.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import threading
import types
import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

Dtype = Any
initializers = jax.nn.initializers
gelu = jax.nn.gelu

__all__ = [
    "Conv", "Dense", "Dropout", "LayerNorm", "Module", "checkpoint",
    "compact", "flatten_dict", "gelu", "initializers", "intercept_methods",
    "map_variables", "remat", "unflatten_dict",
]


class _Context(threading.local):
    def __init__(self):
        self.module_stack: list = []
        self.interceptors: list = []


_ctx = _Context()


def _path_hash(path: Tuple[str, ...], *extra: str) -> int:
    return zlib.crc32("/".join(path + extra).encode()) & 0x7FFFFFFF


class _Scope:
    """Where a bound module reads and creates its parameters.

    ``params`` is this module's subtree of the "params" collection. On
    init, a subtree joins its parent's when its first parameter is
    created, so modules without parameters leave no empty entry."""

    def __init__(self, params: dict, rngs: Dict[str, jax.Array],
                 path: Tuple[str, ...], initializing: bool,
                 counters: Dict[Tuple, int], parent: "_Scope" = None):
        self.params = params
        self.rngs = rngs
        self.path = path
        self.initializing = initializing
        self.counters = counters
        self.parent = parent
        self.pending: Dict[str, dict] = {}

    def child(self, name: str, params_fn: Optional[Callable] = None):
        sub = self.params.get(name)
        if sub is None:
            sub = self.pending.setdefault(name, {})
        if params_fn is not None and not self.initializing:
            sub = params_fn(sub)
        return _Scope(sub, self.rngs, self.path + (name,),
                      self.initializing, self.counters, parent=self)

    def attach(self) -> None:
        """Link this subtree into the root (init only)."""
        if self.parent is None:
            return
        name = self.path[-1]
        if name not in self.parent.params:
            self.parent.params[name] = self.params
            self.parent.pending.pop(name, None)
            self.parent.attach()

    def make_rng(self, stream: str) -> jax.Array:
        if stream not in self.rngs:
            raise ValueError(
                f"module {'/'.join(self.path) or '<root>'} needs the "
                f"{stream!r} PRNG key (pass rngs={{{stream!r}: key}})"
            )
        key = (self.path, stream)
        n = self.counters.get(key, 0)
        self.counters[key] = n + 1
        k = jax.random.fold_in(self.rngs[stream], _path_hash(self.path))
        return jax.random.fold_in(k, n)


def _normalize_rngs(rngs) -> Dict[str, jax.Array]:
    if rngs is None:
        return {}
    if isinstance(rngs, dict):
        return dict(rngs)
    return {"params": rngs}


def compact(fn: Callable) -> Callable:
    """Marks the method whose body constructs submodules inline."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if self._scope is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                f"init/apply or inside a parent module"
            )
        self._autoname_counts = {}
        _ctx.module_stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            _ctx.module_stack.pop()

    wrapper._compact = True
    return wrapper


def _intercepted(fn: Callable, method_name: str) -> Callable:
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if not _ctx.interceptors or self._scope is None:
            return fn(self, *args, **kwargs)
        context = _InterceptContext(self, method_name)

        def run(i, args, kwargs):
            if i < 0:
                return fn(self, *args, **kwargs)
            return _ctx.interceptors[i](
                lambda *a, **k: run(i - 1, a, k), args, kwargs, context
            )

        return run(len(_ctx.interceptors) - 1, args, kwargs)

    return wrapper


def _in_context(fn: Callable) -> Callable:
    """Submodules constructed while a bound module's method runs bind to
    that module."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if self._scope is None:
            return fn(self, *args, **kwargs)
        _ctx.module_stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            _ctx.module_stack.pop()

    return wrapper


@dataclasses.dataclass(frozen=True)
class _InterceptContext:
    module: "Module"
    method_name: str


@contextlib.contextmanager
def intercept_methods(interceptor: Callable):
    """Route every bound module's ``__call__`` through
    ``interceptor(next_fn, args, kwargs, context)`` while active
    (``context.module``, ``context.method_name``)."""
    _ctx.interceptors.append(interceptor)
    try:
        yield
    finally:
        _ctx.interceptors.pop()


class Module:
    """Base class. Subclasses are dataclasses; ``name`` is keyword-only."""

    # Class-level defaults; bound instances set their own.
    _scope: Optional[_Scope] = None
    _params_fn: Optional[Callable] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        anns = cls.__dict__.get("__annotations__", {})
        for attr, fn in list(cls.__dict__.items()):
            if (
                not isinstance(fn, types.FunctionType)
                or attr in anns
                or attr in ("setup", "__post_init__")
                or (attr.startswith("__") and attr != "__call__")
                or getattr(fn, "_compact", False)
            ):
                continue
            setattr(cls, attr, _in_context(fn))
        if "__call__" in cls.__dict__:
            cls.__call__ = _intercepted(cls.__dict__["__call__"], "__call__")
        if "name" not in anns:
            cls.__annotations__ = {**anns, "name": Optional[str]}
            cls.name = dataclasses.field(default=None, kw_only=True)
        dataclasses.dataclass(cls, eq=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_setup_done", False)
        parent = _ctx.module_stack[-1] if _ctx.module_stack else None
        if parent is None or parent._scope is None:
            return
        name = self.name
        if name is None:
            cls_name = type(self).__name__
            n = parent._autoname_counts.get(cls_name, 0)
            parent._autoname_counts[cls_name] = n + 1
            name = f"{cls_name}_{n}"
            object.__setattr__(self, "name", name)
        self._bind(parent._scope.child(name, type(self)._params_fn))

    def _bind(self, scope: _Scope) -> None:
        object.__setattr__(self, "_scope", scope)
        object.__setattr__(self, "_autoname_counts", {})
        object.__setattr__(self, "_setup_done", False)

    def __getattr__(self, attr: str):
        # Attributes assigned in setup() appear on first use.
        if attr.startswith("__") or self.__dict__.get("_setup_done", True):
            raise AttributeError(attr)
        if self.__dict__.get("_scope") is None:
            raise AttributeError(attr)
        self._run_setup()
        return object.__getattribute__(self, attr)

    def _run_setup(self) -> None:
        object.__setattr__(self, "_setup_done", True)
        _ctx.module_stack.append(self)
        try:
            self.setup()
        finally:
            _ctx.module_stack.pop()

    def setup(self) -> None:
        pass

    # -- variables --------------------------------------------------------

    def param(self, name: str, init_fn: Callable, *init_args) -> Any:
        scope = self._scope
        if scope is None:
            raise RuntimeError(f"{type(self).__name__} is not bound")
        if name in scope.params:
            return scope.params[name]
        if not scope.initializing:
            raise KeyError(
                f"missing parameter {'/'.join(scope.path + (name,))}"
            )
        if "params" not in scope.rngs:
            raise ValueError("init needs a 'params' PRNG key")
        key = jax.random.fold_in(
            scope.rngs["params"], _path_hash(scope.path, name)
        )
        value = init_fn(key, *init_args)
        scope.params[name] = value
        scope.attach()
        return value

    def get_variable(self, collection: str, name: str) -> Any:
        if collection != "params" or self._scope is None:
            return None
        return self._scope.params.get(name)

    def make_rng(self, stream: str) -> jax.Array:
        return self._scope.make_rng(stream)

    # -- entry points -----------------------------------------------------

    def _bound_root(self, params: dict, rngs, initializing: bool):
        clone = copy.copy(self)
        clone._bind(_Scope(params, _normalize_rngs(rngs), (), initializing,
                           {}))
        return clone

    @staticmethod
    def _resolve(clone, method):
        if method is None:
            return clone.__call__
        if isinstance(method, str):
            return getattr(clone, method)
        return functools.partial(method, clone)

    def init(self, rngs, *args, method=None, **kwargs) -> Dict[str, Any]:
        """Run ``method`` (default ``__call__``) creating every parameter
        it touches; returns ``{"params": tree}``."""
        params: dict = {}
        clone = self._bound_root(params, rngs, True)
        _ctx.module_stack.append(clone)
        try:
            self._resolve(clone, method)(*args, **kwargs)
        finally:
            _ctx.module_stack.pop()
        return {"params": params}

    def apply(self, variables: Dict[str, Any], *args, rngs=None,
              method=None, **kwargs):
        """Run ``method`` (default ``__call__``) on ``variables["params"]``."""
        clone = self._bound_root(variables["params"], rngs, False)
        _ctx.module_stack.append(clone)
        try:
            return self._resolve(clone, method)(*args, **kwargs)
        finally:
            _ctx.module_stack.pop()


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def remat(target, static_argnums: Sequence[int] = ()):
    """``jax.checkpoint`` over a module class's ``__call__`` or over a
    function whose first argument is a bound module. ``static_argnums``
    count the method's arguments with ``self`` as 0. On init the target
    runs plainly, so parameters are created outside the trace."""
    if isinstance(target, type) and issubclass(target, Module):
        static = tuple(i - 1 for i in static_argnums)
        base_call = target.__call__

        def __call__(self, *args):
            if self._scope.initializing:
                return base_call(self, *args)
            return jax.checkpoint(
                lambda *a: base_call(self, *a), static_argnums=static
            )(*args)

        return type(target.__name__, (target,), {"__call__": __call__})

    if static_argnums:
        raise ValueError("static_argnums applies to module classes only")

    def wrapped(module: Module, *args):
        if module._scope.initializing:
            return target(module, *args)
        return jax.checkpoint(lambda *a: target(module, *a))(*args)

    return wrapped


checkpoint = remat


def map_variables(target: type, trans_in_fn: Callable) -> type:
    """Subclass of ``target`` whose parameters pass through
    ``trans_in_fn`` (its own subtree in, same structure out) on apply."""
    return type(
        target.__name__, (target,), {"_params_fn": staticmethod(trans_in_fn)}
    )


def flatten_dict(tree: dict, prefix: Tuple[str, ...] = ()) -> dict:
    """{"a": {"b": x}} -> {("a", "b"): x} (empty subtrees dropped)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_dict(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _promote(*xs, dtype):
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x: jax.Array) -> jax.Array:
        kernel = self.param(
            "kernel", self.kernel_init, (x.shape[-1], self.features),
            self.param_dtype,
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,),
                       self.param_dtype)
            if self.use_bias else None
        )
        dtype = self.dtype or jnp.result_type(x, kernel)
        x, kernel, bias = _promote(x, kernel, bias, dtype=dtype)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class Conv(Module):
    """N-d convolution over channels-last inputs; kernel
    ``(*kernel_size, in_features // feature_group_count, features)``."""

    features: int
    kernel_size: Sequence[int]
    strides: Optional[Sequence[int]] = None
    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME"
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x: jax.Array) -> jax.Array:
        ks = tuple(self.kernel_size)
        nd = len(ks)
        strides = tuple(self.strides) if self.strides else (1,) * nd
        padding = self.padding
        if not isinstance(padding, str):
            padding = [tuple(p) for p in padding]
        kernel = self.param(
            "kernel", self.kernel_init,
            ks + (x.shape[-1] // self.feature_group_count, self.features),
            self.param_dtype,
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,),
                       self.param_dtype)
            if self.use_bias else None
        )
        dtype = self.dtype or jnp.result_type(x, kernel)
        x, kernel, bias = _promote(x, kernel, bias, dtype=dtype)
        rank = x.ndim
        lhs = (0, rank - 1) + tuple(range(1, rank - 1))
        rhs = (rank - 1, rank - 2) + tuple(range(0, rank - 2))
        y = lax.conv_general_dilated(
            x, kernel, strides, padding,
            dimension_numbers=lax.ConvDimensionNumbers(lhs, rhs, lhs),
            feature_group_count=self.feature_group_count,
        )
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class LayerNorm(Module):
    """Normalizes the last axis; statistics in float32 or wider."""

    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32

    @compact
    def __call__(self, x: jax.Array) -> jax.Array:
        feat = x.shape[-1]
        stat_dtype = jnp.promote_types(x.dtype, jnp.float32)
        xs = x.astype(stat_dtype)
        mean = jnp.mean(xs, axis=-1, keepdims=True)
        mean2 = jnp.mean(jnp.square(xs), axis=-1, keepdims=True)
        var = jnp.maximum(0.0, mean2 - jnp.square(mean))
        scale = self.param("scale", initializers.ones, (feat,),
                           self.param_dtype)
        bias = self.param("bias", initializers.zeros, (feat,),
                          self.param_dtype)
        y = (x - mean) * (lax.rsqrt(var + self.epsilon) * scale) + bias
        return jnp.asarray(y, self.dtype or jnp.result_type(x, scale))


class Dropout(Module):
    """Inverted dropout from the "dropout" stream; identity when
    ``deterministic`` or at rate 0."""

    rate: float

    @compact
    def __call__(self, x: jax.Array, deterministic: bool) -> jax.Array:
        if self.rate == 0.0 or deterministic:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep_prob = 1.0 - self.rate
        keep = jax.random.bernoulli(self.make_rng("dropout"), keep_prob,
                                    x.shape)
        return lax.select(keep, x / keep_prob, jnp.zeros_like(x))
