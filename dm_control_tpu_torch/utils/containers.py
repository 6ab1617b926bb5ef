# Copied from dm_control_tpu/utils/containers.py (pure Python).
"""Tagged task registry (behavioural parity with reference
dm_control/utils/containers.py:25-115)."""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Iterable, Tuple


class TaggedTasks:
  """Maps task names to factories, with tag-based filtering."""

  def __init__(self, allow_overriding_keys: bool = False):
    self._tasks: Dict[str, Callable] = {}
    self._tags: Dict[str, Dict[str, Callable]] = {}
    self.allow_overriding_keys = allow_overriding_keys

  def add(self, *tags: str):
    def wrap(factory: Callable) -> Callable:
      name = factory.__name__
      if name in self._tasks and not self.allow_overriding_keys:
        raise ValueError(
            f'Task {name!r} already registered; pass '
            f'allow_overriding_keys=True to allow this.')
      self._tasks[name] = factory
      for tag in tags:
        self._tags.setdefault(tag, {})[name] = factory
      return factory
    return wrap

  def tagged(self, *tags: str) -> Dict[str, Callable]:
    if not tags:
      return {}
    tags = set(tags)
    if not tags.issubset(self._tags):
      return {}
    out = dict(self._tags[tags.pop()])
    for tag in tags:
      out = {k: v for k, v in out.items() if k in self._tags[tag]}
    return out

  def tags(self) -> Iterable[str]:
    return list(self._tags)

  def __getitem__(self, name: str) -> Callable:
    return self._tasks[name]

  def get(self, name, default=None):
    return self._tasks.get(name, default)

  def __contains__(self, name) -> bool:
    return name in self._tasks

  def __iter__(self):
    return iter(self._tasks)

  def __len__(self):
    return len(self._tasks)

  def items(self):
    return self._tasks.items()

  def keys(self):
    return self._tasks.keys()

  def values(self):
    return self._tasks.values()
