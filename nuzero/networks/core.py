"""A minimal module system for the network zoo, in plain JAX.

A module is a frozen dataclass whose ``__call__`` declares its parameters
inline (``self.param``) and calls its submodules.  ``module.init(key, ...)``
runs the forward pass once to build the variables ``{"params": tree}``;
``module.apply(variables, ...)`` runs it on given variables.  Submodules are
named ``<ClassName>_<k>`` in call order within their parent (``k`` counts
per class), or by an explicit ``name=``; the parameter tree nests by those
names, which is the layout the committed checkpoints use.

Each parameter's initial value is drawn from the init key folded with a
CRC of its path, so it depends on the key and the path only, never on the
order of creation, and every process of a multi-host run draws the same.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

initializers = jax.nn.initializers
relu = jax.nn.relu
elu = jax.nn.elu
silu = jax.nn.silu
tanh = jnp.tanh

_state = threading.local()


class _Scope:
    """The variables of one module instance during one init/apply."""

    def __init__(self, params: dict, key: Optional[jax.Array], path: tuple):
        self.params = params
        self.key = key  # None when applying
        self.path = path
        self.counts: dict[str, int] = {}

    def child(self, cls_name: str, name: Optional[str]) -> "_Scope":
        if name is None:
            k = self.counts.get(cls_name, 0)
            self.counts[cls_name] = k + 1
            name = f"{cls_name}_{k}"
        path = self.path + (name,)
        if self.key is not None:
            sub = self.params.setdefault(name, {})
        elif name in self.params:
            sub = self.params[name]
        else:
            raise KeyError(f"no variables for module {'/'.join(path)}")
        return _Scope(sub, self.key, path)


def _stack() -> list:
    if not hasattr(_state, "scopes"):
        _state.scopes = []
    return _state.scopes


def _run(scope: _Scope, fn: Callable, module, args, kwargs):
    stack = _stack()
    stack.append(scope)
    try:
        return fn(module, *args, **kwargs)
    finally:
        stack.pop()


def _current() -> _Scope:
    stack = _stack()
    if not stack:
        raise RuntimeError("modules run only inside init() or apply()")
    return stack[-1]


def initializing() -> bool:
    """True while ``init`` is building the variables."""
    return _current().key is not None


@dataclasses.dataclass(frozen=True)
class Module:
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        raw = cls.__dict__.get("__call__")
        if raw is None:
            return

        @functools.wraps(raw)
        def call(self, *args, **kw):
            scope = _current().child(type(self).__name__, self.name)
            return _run(scope, raw, self, args, kw)

        cls.__call__ = call

    def init(self, key: jax.Array, *args, **kwargs) -> dict:
        params: dict = {}
        _run(_Scope(params, key, ()), type(self).__call__.__wrapped__, self, args, kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, **kwargs) -> Any:
        scope = _Scope(variables["params"], None, ())
        return _run(scope, type(self).__call__.__wrapped__, self, args, kwargs)

    def param(self, name: str, init_fn: Callable, shape, dtype=jnp.float32):
        scope = _current()
        if name in scope.params:
            return scope.params[name]
        path = "/".join(scope.path + (name,))
        if scope.key is None:
            raise KeyError(f"no parameter {path}")
        key = jax.random.fold_in(scope.key, zlib.crc32(path.encode()))
        value = init_fn(key, shape, dtype)
        scope.params[name] = value
        return value


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        kernel = self.param(
            "kernel", initializers.lecun_normal(), (x.shape[-1], self.features)
        )
        y = jnp.dot(x.astype(self.dtype), kernel.astype(self.dtype))
        if self.use_bias:
            bias = self.param("bias", initializers.zeros, (self.features,))
            y = y + bias.astype(self.dtype)
        return y


class Conv(Module):
    """Bias-free 'SAME' 2-D convolution over NHWC, kernel HWIO."""

    features: int
    kernel_size: tuple = (3, 3)
    feature_group_count: int = 1
    dtype: Any = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        shape = tuple(self.kernel_size) + (
            x.shape[-1] // self.feature_group_count,
            self.features,
        )
        kernel = self.param("kernel", initializers.lecun_normal(), shape)
        return jax.lax.conv_general_dilated(
            x.astype(self.dtype),
            kernel.astype(self.dtype),
            window_strides=(1, 1),
            padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=self.feature_group_count,
        )
