"""Strict Prometheus text-exposition parser — the CI exposition-format gate.

Parses the classic text format (``text/plain; version=0.0.4``) with **no
external dependencies** and deliberately stricter rules than a scraping server
would apply, so a malformed metric name, label, escape, or duplicate series
fails the tier-1 suite (and the CI step over live soak snapshots) instead of
silently dropping data at scrape time:

* metric names must match ``[a-zA-Z_:][a-zA-Z0-9_:]*``; label names must match
  ``[a-zA-Z_][a-zA-Z0-9_]*`` and may not start with ``__`` (reserved);
* label values admit exactly the spec escapes ``\\\\``, ``\\"``, ``\\n``;
* every sample needs a preceding ``# TYPE`` for its family, declared once,
  with all of the family's samples contiguous (no interleaving);
* ``counter`` families must be named ``*_total`` (OpenMetrics rule, adopted);
* duplicate ``(name, label set)`` series are an error;
* only ``# HELP`` / ``# TYPE`` comment forms are allowed (the exporter emits
  nothing else, so anything else in a snapshot is corruption);
* the exposition must end with a newline.

Run as a module to gate snapshot files::

    PYTHONPATH=src python -m repro_torch.monitor.promparse soak_snapshots/*.prom
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["Exposition", "ExpositionError", "main", "parse_exposition"]

_METRIC_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_TYPES = frozenset({"counter", "gauge", "histogram", "summary", "untyped"})
#: sample-name suffixes each complex type may add to its family name
_TYPE_SUFFIXES = {
    "histogram": ("", "_bucket", "_sum", "_count"),
    "summary": ("", "_sum", "_count"),
}

LabelSet = tuple[tuple[str, str], ...]


class ExpositionError(ValueError):
    """A violation of the text exposition format (line number included)."""

    def __init__(self, lineno: int, message: str) -> None:
        super().__init__(f"line {lineno}: {message}")
        self.lineno = lineno


@dataclass
class Exposition:
    """Parsed exposition: declared families and every sample, addressable by
    ``(metric name, sorted label items)``."""

    types: dict[str, str] = field(default_factory=dict)
    helps: dict[str, str] = field(default_factory=dict)
    samples: dict[tuple[str, LabelSet], float] = field(default_factory=dict)

    def value(self, name: str, **labels: str) -> float:
        """The sample value for an exact series; KeyError when absent."""
        return self.samples[(name, tuple(sorted(labels.items())))]

    def series(self, name: str) -> dict[LabelSet, float]:
        """All of one metric's series: ``{sorted label items: value}``."""
        return {
            labels: v for (n, labels), v in self.samples.items() if n == name
        }

    @property
    def n_samples(self) -> int:
        return len(self.samples)


def _family_of(name: str, types: dict[str, str]) -> str | None:
    """The declared family a sample name belongs to, or None."""
    if name in types:
        return name
    for family, mtype in types.items():
        for suffix in _TYPE_SUFFIXES.get(mtype, ()):
            if suffix and name == family + suffix:
                return family
    return None


def _parse_labels(lineno: int, text: str, pos: int) -> tuple[LabelSet, int]:
    """Parse ``{name="value",...}`` starting at ``text[pos] == '{'``; returns
    (sorted label items, index just past the closing brace)."""
    labels: list[tuple[str, str]] = []
    seen: set[str] = set()
    pos += 1  # past '{'
    n = len(text)
    while True:
        if pos >= n:
            raise ExpositionError(lineno, "unterminated label set")
        if text[pos] == "}":
            return tuple(sorted(labels)), pos + 1
        eq = text.find("=", pos)
        if eq < 0:
            raise ExpositionError(lineno, "label without '='")
        lname = text[pos:eq]
        if not _LABEL_RE.match(lname) or lname.startswith("__"):
            raise ExpositionError(lineno, f"invalid label name {lname!r}")
        if lname in seen:
            raise ExpositionError(lineno, f"repeated label {lname!r}")
        seen.add(lname)
        pos = eq + 1
        if pos >= n or text[pos] != '"':
            raise ExpositionError(lineno, f"label {lname!r} value not quoted")
        pos += 1
        out: list[str] = []
        while True:
            if pos >= n:
                raise ExpositionError(lineno, f"unterminated value for {lname!r}")
            ch = text[pos]
            if ch == "\\":
                if pos + 1 >= n:
                    raise ExpositionError(lineno, "dangling escape")
                esc = text[pos + 1]
                if esc == "\\":
                    out.append("\\")
                elif esc == '"':
                    out.append('"')
                elif esc == "n":
                    out.append("\n")
                else:
                    raise ExpositionError(lineno, f"invalid escape \\{esc}")
                pos += 2
            elif ch == '"':
                pos += 1
                break
            elif ch == "\n":
                raise ExpositionError(lineno, "raw newline in label value")
            else:
                out.append(ch)
                pos += 1
        labels.append((lname, "".join(out)))
        if pos < n and text[pos] == ",":
            pos += 1
        elif pos < n and text[pos] != "}":
            raise ExpositionError(lineno, "expected ',' or '}' after label")


def _parse_value(lineno: int, token: str) -> float:
    if not token:
        raise ExpositionError(lineno, "missing sample value")
    try:
        return float(token)
    except ValueError:
        raise ExpositionError(lineno, f"invalid sample value {token!r}") from None


def _unescape_help(lineno: int, text: str) -> str:
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "\\":
            if i + 1 >= n:
                raise ExpositionError(lineno, "dangling escape in HELP")
            esc = text[i + 1]
            if esc == "\\":
                out.append("\\")
            elif esc == "n":
                out.append("\n")
            else:
                raise ExpositionError(lineno, f"invalid HELP escape \\{esc}")
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def parse_exposition(text: str) -> Exposition:
    """Parse (and strictly validate) one text exposition; raises
    :class:`ExpositionError` on the first violation."""
    if not text:
        raise ExpositionError(0, "empty exposition")
    if not text.endswith("\n"):
        raise ExpositionError(text.count("\n") + 1, "missing final newline")
    exp = Exposition()
    #: families whose sample block has ended (another family started since)
    closed: set[str] = set()
    current: str | None = None

    for lineno, line in enumerate(text.split("\n")[:-1], start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] == "HELP":
                if len(parts) < 3:
                    raise ExpositionError(lineno, "HELP without metric name")
                name = parts[2]
                if not _METRIC_RE.match(name):
                    raise ExpositionError(lineno, f"invalid metric name {name!r}")
                if name in exp.helps:
                    raise ExpositionError(lineno, f"duplicate HELP for {name}")
                exp.helps[name] = _unescape_help(
                    lineno, parts[3] if len(parts) > 3 else ""
                )
            elif len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4:
                    raise ExpositionError(lineno, "TYPE needs: name + type")
                name, mtype = parts[2], parts[3]
                if not _METRIC_RE.match(name):
                    raise ExpositionError(lineno, f"invalid metric name {name!r}")
                if mtype not in _TYPES:
                    raise ExpositionError(lineno, f"unknown type {mtype!r}")
                if name in exp.types:
                    raise ExpositionError(lineno, f"duplicate TYPE for {name}")
                if name in closed or name == current:
                    raise ExpositionError(
                        lineno, f"TYPE for {name} after its samples"
                    )
                if mtype == "counter" and not name.endswith("_total"):
                    raise ExpositionError(
                        lineno, f"counter {name} must be named *_total"
                    )
                exp.types[name] = mtype
            else:
                raise ExpositionError(
                    lineno, f"unknown comment form {line[:40]!r}"
                )
            continue

        # -- sample line: name[{labels}] value [timestamp] ---------------------
        brace = line.find("{")
        space = line.find(" ")
        name_end = min(x for x in (brace, space, len(line)) if x >= 0)
        name = line[:name_end]
        if not _METRIC_RE.match(name):
            raise ExpositionError(lineno, f"invalid metric name {name!r}")
        family = _family_of(name, exp.types)
        if family is None:
            raise ExpositionError(lineno, f"sample {name} has no # TYPE")
        if family in closed:
            raise ExpositionError(
                lineno, f"samples for {family} are not contiguous"
            )
        if current is not None and current != family:
            closed.add(current)
        current = family

        pos = name_end
        labels: LabelSet = ()
        if pos < len(line) and line[pos] == "{":
            labels, pos = _parse_labels(lineno, line, pos)
        rest = line[pos:].split()
        if not rest or len(rest) > 2:
            raise ExpositionError(
                lineno, "expected: value [timestamp] after name/labels"
            )
        value = _parse_value(lineno, rest[0])
        if len(rest) == 2:
            try:
                int(rest[1])
            except ValueError:
                raise ExpositionError(
                    lineno, f"invalid timestamp {rest[1]!r}"
                ) from None
        key = (name, labels)
        if key in exp.samples:
            raise ExpositionError(
                lineno, f"duplicate series {name}{dict(labels)}"
            )
        exp.samples[key] = value
    return exp


def main(argv=None) -> int:
    """Gate: strictly parse each file; non-zero exit on the first violation."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+", help="exposition snapshot files (.prom)")
    args = ap.parse_args(argv)
    status = 0
    for path in args.files:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        try:
            exp = parse_exposition(text)
        except ExpositionError as exc:
            print(f"[promparse] FAIL {path}: {exc}")
            status = 1
        else:
            print(
                f"[promparse] ok   {path}: {len(exp.types)} families, "
                f"{exp.n_samples} samples"
            )
    return status


if __name__ == "__main__":
    raise SystemExit(main())
