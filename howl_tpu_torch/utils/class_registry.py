"""String-keyed class registry mixin (ref: howl/utils/class_registry.py:6)."""

from __future__ import annotations


class ClassRegistry:
    """Subclasses registered by ``name=...`` in the class statement.

    Example::

        class Base(ClassRegistry):
            registered_map = {}

        class Impl(Base, name="impl"):
            ...

        Base.find_registered_class("impl")  # -> Impl
    """

    registered_map: dict = {}

    def __init_subclass__(cls, name: str = None, **kwargs):
        super().__init_subclass__(**kwargs)
        if name is not None:
            # register on the nearest ancestor that *owns* a registered_map
            for base in cls.__mro__[1:]:
                if "registered_map" in vars(base):
                    vars(base)["registered_map"][name] = cls
                    break
            cls.registered_name = name

    @classmethod
    def find_registered_class(cls, name: str):
        try:
            return cls.registered_map[name]
        except KeyError as e:
            raise ValueError(
                f"unknown registered class {name!r}; available: {sorted(cls.registered_map)}"
            ) from e

    @classmethod
    def registered_names(cls):
        return sorted(cls.registered_map)
