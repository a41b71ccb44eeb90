"""Rate algebra: parsing, unit conversion, formatting.

Parity target: the reference's ``Rate`` (bucket.go:96-153) — a frequency per
duration, parsed from ``"freq:duration"`` strings with bare-unit shorthand
(``"s"`` → ``"1s"``, bucket.go:116-119), converted to tokens via
``float64(d) / float64(interval)`` where ``interval`` is the *truncating*
int64 division ``per / freq`` (bucket.go:146-148).

Durations are represented as integer nanoseconds throughout (Go
``time.Duration`` is an int64 nanosecond count), so that device kernels and
the wire codec share exact semantics with this host-side algebra.
"""

from __future__ import annotations

import dataclasses

NANOS_PER_SECOND = 1_000_000_000

# Unit table of Go time.ParseDuration. Both MICRO SIGN (µ) and GREEK SMALL
# LETTER MU (μ) spell microseconds, as in Go's unitMap.
_UNITS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,  # µs
    "μs": 1_000,  # μs
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
}

# Bare units accepted as "1<unit>" shorthand by ParseRate (bucket.go:116-119).
# Note the reference's list includes µs but not μs.
_BARE_UNITS = ("ns", "us", "µs", "ms", "s", "m", "h")

_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)


def parse_duration(s: str) -> int:
    """Parse a Go-style duration string into integer nanoseconds.

    Mirrors Go ``time.ParseDuration`` (used at bucket.go:121): an optional
    sign, then one or more ``<decimal><unit>`` segments, e.g. ``"1.5h"``,
    ``"2h45m"``, ``"300ms"``. ``"0"`` alone is allowed; a bare number without
    a unit is not.
    """
    orig = s
    neg = False
    if s[:1] in ("+", "-"):
        neg = s[0] == "-"
        s = s[1:]
    if s == "0":
        return 0
    if not s:
        raise ValueError(f"invalid duration {orig!r}")

    total = 0
    while s:
        i = 0
        while i < len(s) and s[i].isascii() and s[i].isdigit():
            i += 1
        int_part, s = s[:i], s[i:]
        frac_part = ""
        if s[:1] == ".":
            s = s[1:]
            j = 0
            while j < len(s) and s[j].isascii() and s[j].isdigit():
                j += 1
            frac_part, s = s[:j], s[j:]
        if not int_part and not frac_part:
            raise ValueError(f"invalid duration {orig!r}")

        unit = next(
            (u for u in sorted(_UNITS, key=len, reverse=True) if s.startswith(u)),
            None,
        )
        if unit is None:
            raise ValueError(f"missing unit in duration {orig!r}")
        s = s[len(unit) :]
        scale = _UNITS[unit]

        total += int(int_part or 0) * scale
        if frac_part:
            # Exact rational scaling, truncated — matches Go's accumulation
            # of fractional digits against the unit scale.
            total += int(frac_part) * scale // 10 ** len(frac_part)
        if total > _INT64_MAX:
            raise ValueError(f"duration {orig!r} overflows int64")

    return -total if neg else total


def format_duration(ns: int) -> str:
    """Format integer nanoseconds the way Go ``time.Duration.String`` does.

    Examples: ``0 → "0s"``, ``1500 → "1.5µs"``, ``90e9 → "1m30s"``.
    """
    if ns == 0:
        return "0s"
    neg = ns < 0
    u = -ns if neg else ns
    if u < NANOS_PER_SECOND:
        if u < 1_000:
            out = f"{u}ns"
        elif u < 1_000_000:
            out = _with_frac(u, 1_000, "µs")
        else:
            out = _with_frac(u, 1_000_000, "ms")
    else:
        secs, frac = divmod(u, NANOS_PER_SECOND)
        out = _with_frac(secs % 60 * NANOS_PER_SECOND + frac, NANOS_PER_SECOND, "s")
        mins = secs // 60
        if mins > 0:
            out = f"{mins % 60}m{out}"
            hours = mins // 60
            if hours > 0:
                out = f"{hours}h{out}"
    return ("-" if neg else "") + out


def _with_frac(value: int, scale: int, unit: str) -> str:
    whole, frac = divmod(value, scale)
    if frac == 0:
        return f"{whole}{unit}"
    digits = str(frac).rjust(len(str(scale)) - 1, "0").rstrip("0")
    return f"{whole}.{digits}{unit}"


def _atoi(s: str) -> int:
    """Go ``strconv.Atoi``: optional sign, ASCII digits, int64 range."""
    body = s[1:] if s[:1] in ("+", "-") else s
    if not body or not body.isascii() or not body.isdigit():
        raise ValueError(f"parsing {s!r}: invalid syntax")
    v = int(s)
    if not _INT64_MIN <= v <= _INT64_MAX:
        raise ValueError(f"parsing {s!r}: value out of range")
    return v


@dataclasses.dataclass(frozen=True)
class Rate:
    """Maximum frequency of events: ``freq`` events per ``per_ns`` nanoseconds.

    A zero Rate (either field zero) allows no events (bucket.go:125-128).
    """

    freq: int = 0
    per_ns: int = 0

    def is_zero(self) -> bool:
        return self.freq == 0 or self.per_ns == 0

    def interval_ns(self) -> int:
        """Interval between events: truncating int64 division per/freq.

        Mirrors bucket.go:146-148 where both operands are int64 and Go's
        division truncates toward zero.
        """
        q = abs(self.per_ns) // abs(self.freq)
        return -q if (self.per_ns < 0) != (self.freq < 0) else q

    def tokens(self, d_ns: int) -> float:
        """Tokens accumulable over ``d_ns`` nanoseconds (bucket.go:130-143)."""
        if self.is_zero():
            return 0.0
        interval = self.interval_ns()
        if interval == 0:
            return 0.0
        return float(d_ns) / float(interval)

    def __str__(self) -> str:
        return f"{self.freq}:{format_duration(self.per_ns)}"


def parse_rate(v: str) -> Rate:
    """Parse ``"freq:duration"`` (e.g. ``"50:1s"``) into a Rate.

    Mirrors ``ParseRate`` (bucket.go:101-123): a missing duration defaults to
    ``"1s"``; a bare unit in the duration position is prefixed with ``"1"``.
    Raises ValueError on malformed input — callers that want the reference
    API's silently-ignored-error behavior (api.go:61) catch and use ``Rate()``.
    """
    parts = v.split(":", 1)
    if len(parts) == 1:
        parts.append("1s")
    freq = _atoi(parts[0])
    per = parts[1]
    if per in _BARE_UNITS:
        per = "1" + per
    return Rate(freq=freq, per_ns=parse_duration(per))
