"""Error types: the port's copy of ``veloci_tpu/error.py`` (reference:
src/error.rs:5-74 `VelociError`)."""

from __future__ import annotations

__all__ = [
    "VelociError",
    "FieldNotFoundError",
    "FstNotFoundError",
    "InvalidRequestError",
    "AllFieldsFilteredError",
]


class VelociError(Exception):
    """Base error for the engine."""


class FieldNotFoundError(VelociError):
    def __init__(self, field: str, all_fields):
        super().__init__(f"field {field!r} not found; available: {sorted(all_fields)}")
        self.field = field
        self.all_fields = list(all_fields)


class FstNotFoundError(VelociError):
    def __init__(self, path: str):
        super().__init__(f"term dictionary not found for {path!r}")
        self.path = path


class InvalidRequestError(VelociError):
    pass


class AllFieldsFilteredError(VelociError):
    def __init__(self, all_fields, filter_):
        super().__init__(
            f"all fields filtered out; all_fields={sorted(all_fields)}, filter={filter_}"
        )


class MissingTextIdError(VelociError):
    pass
