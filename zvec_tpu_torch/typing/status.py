"""Status / error types.

The reference returns `Status`/`Result<T>` (tl::expected) from every db API
(`src/include/zvec/ailego/pattern/expected.hpp`, `src/db/common/status.cc`) and its
Python layer maps per-doc write results to `Status` objects
(`python/zvec/model/collection.py:233-301`). We keep the same user-visible shape:
write ops return `Status` (or a list of them), failures in DDL raise `ZvecError`.
"""

from __future__ import annotations

from typing import Optional

from .enum import StatusCode

__all__ = ["Status", "ZvecError"]


class Status:
    __slots__ = ("code", "message")

    def __init__(self, code: StatusCode = StatusCode.OK, message: str = ""):
        object.__setattr__(self, "code", StatusCode(code))
        object.__setattr__(self, "message", message)

    def __setattr__(self, name, value):
        # immutable: ok() returns a shared instance; a mutable status would
        # let one caller rewrite every future OK status process-wide
        raise AttributeError("Status is immutable; build a new one instead")

    @classmethod
    def ok_status(cls) -> "Status":
        # shared immutable OK instance: write paths return one per doc
        # (measured 7% of a vector-only insert batch in allocations)
        return _OK

    @classmethod
    def error(cls, code: StatusCode, message: str = "") -> "Status":
        return cls(code, message)

    def ok(self) -> bool:
        """Instance truth check — reference parity: every caller writes
        `result.ok()` (`python/tests/.../result.ok()` idiom). The shared-OK
        factory moved to `Status.ok_status()` (round-3 fix: the classmethod
        used to shadow this name, so `status.ok()` returned the OK singleton
        even on an error status — silently truthy)."""
        return self.code == StatusCode.OK

    is_ok = ok

    @property
    def ok_(self) -> bool:  # reference-style truthiness helper
        return self.is_ok()

    def __bool__(self) -> bool:
        return self.is_ok()

    def __eq__(self, other) -> bool:
        if isinstance(other, Status):
            return self.code == other.code
        if isinstance(other, StatusCode):
            return self.code == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.code)

    def __repr__(self) -> str:
        if self.message:
            return f"Status({self.code.name}, {self.message!r})"
        return f"Status({self.code.name})"

    def raise_if_error(self) -> "Status":
        if not self.is_ok():
            raise ZvecError(self.code, self.message)
        return self


_OK = Status(StatusCode.OK)


class ZvecError(RuntimeError):
    """Exception carrying a StatusCode, raised by DDL/DQL failures."""

    def __init__(self, code: StatusCode, message: str = ""):
        super().__init__(f"[{StatusCode(code).name}] {message}")
        self.code = StatusCode(code)
        self.status_message = message

    def status(self) -> Status:
        return Status(self.code, self.status_message)


def invalid_argument(message: str) -> ZvecError:
    return ZvecError(StatusCode.INVALID_ARGUMENT, message)


def not_found(message: str) -> ZvecError:
    return ZvecError(StatusCode.NOT_FOUND, message)
