"""MetricsRegistry: zero-sync telemetry, port of ``repro.obs.registry``.

Three metric kinds with different cost models:

``device counters``  lazy on-device tensor adds (``accumulate``) folded
                     onto the metric dicts the phases already return — no
                     ``.item()``, no host sync on the hot path;
``host counters``    plain Python ints for host-side decisions;
``gauges``           callables evaluated only at ``snapshot()`` time.

``snapshot()`` is the one host-transfer point; ``peek()`` hands back the
raw device tensor for callers composing further device arithmetic.
``view(prefix)`` adapts a namespace of host counters to a
``MutableMapping``.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, List, MutableMapping, Optional

import torch


def _host(v: torch.Tensor) -> object:
    v = v.detach().cpu()
    return v.item() if v.dim() == 0 else v.numpy()


class MetricsRegistry:
    def __init__(self):
        self._device: Dict[str, torch.Tensor] = {}
        self._device_init: Dict[str, torch.Tensor] = {}
        self._host: Dict[str, object] = {}
        self._gauges: Dict[str, Callable[[], object]] = {}
        self._lock = threading.Lock()

    # -- device counters (zero-sync accumulation) -------------------------
    def declare(self, name: str, template: torch.Tensor) -> None:
        """Declare a device counter with an explicit zero template (shape,
        dtype, device). Re-declaring resets it to zero."""
        zero = torch.zeros_like(template)
        with self._lock:
            self._device[name] = zero
            self._device_init[name] = zero

    def accumulate(self, name: str, delta: torch.Tensor) -> None:
        """Device-side ``total += delta`` (lazy, no host sync). Undeclared
        names are declared by their first delta."""
        with self._lock:
            cur = self._device.get(name)
            if cur is None:
                self._device_init[name] = torch.zeros_like(delta)
                self._device[name] = delta
            else:
                self._device[name] = cur + delta

    def accumulate_max(self, name: str, value: torch.Tensor) -> None:
        """Device-side ``total = max(total, value)``."""
        with self._lock:
            cur = self._device.get(name)
            if cur is None:
                self._device_init[name] = torch.zeros_like(value)
                self._device[name] = value
            else:
                self._device[name] = torch.maximum(cur, value)

    def peek(self, name: str) -> torch.Tensor:
        """The raw device accumulator (no transfer)."""
        return self._device[name]

    def reset(self, name: Optional[str] = None) -> None:
        """Zero one device counter (or all of them)."""
        with self._lock:
            names = [name] if name is not None else list(self._device)
            for n in names:
                self._device[n] = self._device_init[n]

    # -- host counters -----------------------------------------------------
    def inc(self, name: str, n: object = 1) -> None:
        self._host[name] = self._host.get(name, 0) + n

    def set(self, name: str, value: object) -> None:
        self._host[name] = value

    def get(self, name: str, default: object = None) -> object:
        return self._host.get(name, default)

    # -- gauges (evaluated at snapshot only) -------------------------------
    def register_gauge(self, name: str, fn: Callable[[], object]) -> None:
        self._gauges[name] = fn

    # -- the single host-transfer point ------------------------------------
    def snapshot(self, include_gauges: bool = True) -> Dict[str, object]:
        """Realise every metric on the host: scalar counters as Python
        numbers, vector counters as numpy arrays (in sorted name order, the
        order of the reference's ``jax.device_get`` over the counter
        dict), then host counters and gauge evaluations."""
        with self._lock:
            device = dict(self._device)
        out: Dict[str, object] = {k: _host(v)
                                  for k, v in sorted(device.items())}
        out.update(self._host)
        if include_gauges:
            for k, fn in self._gauges.items():
                out[k] = fn()
        return out

    def value(self, name: str) -> object:
        """One metric's host value (syncs that metric only)."""
        if name in self._device:
            return _host(self._device[name])
        if name in self._host:
            return self._host[name]
        return self._gauges[name]()

    def names(self) -> List[str]:
        return list(self._device) + list(self._host) + list(self._gauges)

    def view(self, prefix: str = "") -> "MetricsView":
        return MetricsView(self, prefix)


class MetricsView(MutableMapping):
    """A ``MutableMapping`` over one prefix-namespace of a registry's HOST
    counters (iteration order = declaration order)."""

    def __init__(self, registry: MetricsRegistry, prefix: str = ""):
        self._registry = registry
        self._prefix = prefix

    def _key(self, key: str) -> str:
        return self._prefix + key

    def __getitem__(self, key: str) -> object:
        full = self._key(key)
        if full not in self._registry._host:
            raise KeyError(key)
        return self._registry._host[full]

    def __setitem__(self, key: str, value: object) -> None:
        self._registry._host[self._key(key)] = value

    def __delitem__(self, key: str) -> None:
        del self._registry._host[self._key(key)]

    def __iter__(self) -> Iterator[str]:
        p = self._prefix
        for k in self._registry._host:
            if k.startswith(p):
                yield k[len(p):]

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __repr__(self) -> str:
        return repr(dict(self))
