"""Banks: named containers of exported/private objects plus dependencies.

Behavioral model from reference src/bank.c: a bank has an exports
name table, a private name table, and a dependency handle table.  Path
lookup ("bank/prog") and the shared-bank load cache are provided by the
engine state (see engine/state.py), matching a2_Load/a2_Get semantics
(bank.c:181-230, 348-390).
"""

from ..constants import A2ObjType
from ..errors import A2Error, A2Exception


class Bank:
    def __init__(self, name):
        self.name = name
        self.exports = {}    # name -> handle (insertion ordered)
        self.private = {}    # name -> handle
        self.deps = []       # handles (each holds one reference)

    def add_dep(self, handle):
        if handle not in self.deps:
            self.deps.append(handle)
            return True
        return False

    def find(self, name):
        h = self.exports.get(name)
        if h is None:
            h = self.private.get(name)
        return h

    def export_name_of(self, handle):
        for n, h in self.exports.items():
            if h == handle:
                return n
        return None


class Constant:
    __slots__ = ("value",)

    def __init__(self, value: float):
        self.value = value


class A2String:
    __slots__ = ("value",)

    def __init__(self, value: str):
        self.value = value
