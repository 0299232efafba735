"""SymbolTable: string <-> id mapping with merge and serialization (the
port's own copy of vallex_tpu/utils/symbol_table.py; pure Python).

The API of the reference's k2-style table (utils/symbol_table.py:30-287),
so custom vocabularies written for it keep working: one forward dict is the
source of truth and the inverse is kept beside it; malformed input raises
ValueError.

Serialized form (one mapping per line, id second):

    <eps> 0
    a 1
    b 2
"""

from __future__ import annotations

from typing import Dict, Generic, Iterable, List, Optional, Tuple, TypeVar, Union

Symbol = TypeVar("Symbol")

EPS_ID = 0


class SymbolTable(Generic[Symbol]):
    def __init__(
        self,
        mappings: Optional[Iterable[Tuple[Symbol, int]]] = None,
        eps: Symbol = "<eps>",
    ):
        self.eps = eps
        self._fwd: Dict[Symbol, int] = {}  # symbol -> id (source of truth)
        self._inv: Dict[int, Symbol] = {}
        for sym, idx in mappings or ():
            self._insert(sym, idx)
        if EPS_ID not in self._inv:
            self._insert(eps, EPS_ID)
        else:
            self.eps = self._inv[EPS_ID]

    # -- construction ------------------------------------------------------

    def _insert(self, sym: Symbol, idx: int) -> None:
        if idx < 0:
            raise ValueError(f"negative id {idx} for symbol {sym!r}")
        if sym in self._fwd and self._fwd[sym] != idx:
            raise ValueError(f"symbol {sym!r} already mapped to {self._fwd[sym]}")
        if idx in self._inv and self._inv[idx] != sym:
            raise ValueError(f"id {idx} already mapped to {self._inv[idx]!r}")
        self._fwd[sym] = idx
        self._inv[idx] = sym

    @classmethod
    def from_str(cls, s: str) -> "SymbolTable":
        pairs = []
        for lineno, line in enumerate(s.splitlines(), 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(
                    f"line {lineno}: expected '<symbol> <id>', got {line!r}"
                )
            pairs.append((parts[0], int(parts[1])))
        return cls(pairs)

    @classmethod
    def from_file(cls, filename: str) -> "SymbolTable":
        with open(filename, encoding="utf-8") as f:
            return cls.from_str(f.read())

    # -- serialization -----------------------------------------------------

    def to_str(self) -> str:
        return "\n".join(
            f"{self._inv[i]} {i}" for i in sorted(self._inv)
        )

    def to_file(self, filename: str) -> None:
        with open(filename, "w", encoding="utf-8") as f:
            f.write(self.to_str() + "\n")

    # -- mutation ----------------------------------------------------------

    def add(self, symbol: Symbol, index: Optional[int] = None) -> int:
        if symbol in self._fwd:
            return self._fwd[symbol]
        if index is None:
            index = max(self._inv, default=-1) + 1
        self._insert(symbol, index)
        return index

    # -- lookup ------------------------------------------------------------

    def get(self, k: Union[int, Symbol]) -> Union[Symbol, int]:
        return self._inv[k] if isinstance(k, int) else self._fwd[k]

    def __getitem__(self, item: Union[int, Symbol]) -> Union[Symbol, int]:
        return self.get(item)

    def __contains__(self, item: Union[int, Symbol]) -> bool:
        return item in (self._inv if isinstance(item, int) else self._fwd)

    def __len__(self) -> int:
        return len(self._fwd)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SymbolTable):
            return NotImplemented
        return self._fwd == other._fwd

    # -- combination -------------------------------------------------------

    def merge(self, other: "SymbolTable") -> "SymbolTable":
        """Union of both tables; overlapping entries must agree exactly."""
        if self.eps != other.eps:
            raise ValueError(f"eps mismatch: {self.eps!r} vs {other.eps!r}")
        combined = dict(self._fwd)
        for sym, idx in other._fwd.items():
            if combined.get(sym, idx) != idx:
                raise ValueError(
                    f"symbol {sym!r}: id {combined[sym]} vs {idx}"
                )
            combined[sym] = idx
        # id conflicts (two symbols claiming one id) must be diagnosed
        # BEFORE construction — the constructor's _insert would raise its
        # generic message first, making the friendly one unreachable
        for idx in self._inv.keys() & other._inv.keys():
            if self._inv[idx] != other._inv[idx]:
                raise ValueError(
                    f"id {idx}: {self._inv[idx]!r} vs {other._inv[idx]!r}"
                )
        return SymbolTable(combined.items(), eps=self.eps)

    # -- views ---------------------------------------------------------------

    @property
    def ids(self) -> List[int]:
        return sorted(self._inv)

    @property
    def symbols(self) -> List[Symbol]:
        return [self._inv[i] for i in sorted(self._inv)]
