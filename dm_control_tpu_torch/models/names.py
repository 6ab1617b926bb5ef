# Copied from dm_control_tpu/models/names.py (pure Python and numpy).
"""Hashable name tables attached to a compiled Model.

Stored as Model metadata so that name->id resolution is available wherever
the model is, while remaining hashable for the jit cache key.
"""

from __future__ import annotations

from typing import Dict, Tuple


class Names:
  """Immutable name registry for all object namespaces."""

  NAMESPACES = ('body', 'joint', 'geom', 'site', 'camera', 'light',
                'actuator', 'tendon', 'sensor', 'equality', 'key', 'mocap')

  def __init__(self, tables: Dict[str, Tuple[str, ...]]):
    object.__setattr__(self, '_tables', {
        ns: tuple(tables.get(ns, ())) for ns in self.NAMESPACES})
    object.__setattr__(self, '_lookup', {
        ns: {n: i for i, n in enumerate(t) if n}
        for ns, t in self._tables.items()})

  def __setattr__(self, *_):
    raise AttributeError('Names is immutable')

  def names(self, namespace: str) -> Tuple[str, ...]:
    return self._tables[namespace]

  def name2id(self, namespace: str, name: str) -> int:
    try:
      return self._lookup[namespace][name]
    except KeyError:
      raise KeyError(
          f'no {namespace} named {name!r}; have '
          f'{sorted(self._lookup[namespace])}') from None

  def id2name(self, namespace: str, idx: int) -> str:
    return self._tables[namespace][idx]

  def __contains__(self, key):
    namespace, name = key
    return name in self._lookup[namespace]

  def _key(self):
    return tuple((ns, self._tables[ns]) for ns in self.NAMESPACES)

  def __hash__(self):
    return hash(self._key())

  def __eq__(self, other):
    return isinstance(other, Names) and self._key() == other._key()

  def __repr__(self):
    sizes = {ns: len(t) for ns, t in self._tables.items() if t}
    return f'Names({sizes})'
