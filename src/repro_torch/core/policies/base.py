"""String-keyed policy registry (own copy of the reference's
``core/policies/base.py``, admission kind only — the routing and decode
policies belong to the Conductor/simulator, which the port does not
carry yet).

``@register_policy(kind, name)`` stamps and registers a class;
``get_policy(kind, name)`` resolves it, raising a ``ValueError`` that
lists what is registered for that kind.
"""
from __future__ import annotations

POLICY_KINDS = ("admission",)

_REGISTRY: dict[tuple[str, str], type] = {}


def register_policy(kind: str, name: str):
    if kind not in POLICY_KINDS:
        raise ValueError(f"unknown policy kind {kind!r}; "
                         f"kinds: {list(POLICY_KINDS)}")

    def deco(cls):
        cls.kind = kind
        cls.name = name
        _REGISTRY[(kind, name)] = cls
        return cls
    return deco


_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True  # before the import: admission re-enters here
    import importlib
    importlib.import_module("repro_torch.core.policies.admission")


def get_policy(kind: str, name: str) -> type:
    _ensure_builtins()
    try:
        return _REGISTRY[(kind, name)]
    except KeyError:
        known = sorted(n for k, n in _REGISTRY if k == kind)
        raise ValueError(
            f"unknown {kind} policy {name!r}; registered: {known}") from None
