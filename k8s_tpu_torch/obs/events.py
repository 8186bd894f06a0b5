"""Structured-event parsing: the ``{"event": ...}`` JSON-lines contract
(the port's copy of ``k8s_tpu/obs/events.py``).

Every program under the launcher emits machine-readable lifecycle
events as single-line JSON objects with an ``"event"`` key
(``serving_ready``, ``restored``, ``ckpt_goodput``, ``router_drained``,
``step_phases``, ...). This is the one parser the tests and
``chip_smoke.py`` read a launcher's stdout with.

Default parsing is tolerant — pod logs interleave event lines with
free-form prints, tracebacks, and (after a SIGKILL) a possibly
truncated final line, none of which should crash a post-mortem.
``strict=True`` raises on a line that *claims* to be an event
(contains ``"event"``) but does not parse or validate — the mode for
asserting a producer's own output is well-formed.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional


class EventParseError(ValueError):
    """A line that looks like an event is not a valid event record."""


def iter_events(text: str, strict: bool = False) -> Iterator[dict]:
    """Yield every valid event dict in ``text``, in order."""
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line.startswith("{"):
            continue
        looks_like_event = '"event"' in line
        try:
            obj = json.loads(line)
        except ValueError:
            if strict and looks_like_event:
                raise EventParseError(
                    f"line {lineno}: unparseable event line: {line[:200]}")
            continue
        if not isinstance(obj, dict):
            continue
        ev = obj.get("event")
        if isinstance(ev, str) and ev:
            yield obj
        elif strict and looks_like_event:
            raise EventParseError(
                f"line {lineno}: \"event\" key is not a non-empty "
                f"string: {line[:200]}")


def parse_events(text: str, strict: bool = False) -> List[dict]:
    """All event dicts in ``text`` (see :func:`iter_events`)."""
    return list(iter_events(text, strict=strict))


def events_of(text: str, name: str, strict: bool = False) -> List[dict]:
    """All events named ``name``, in emission order."""
    return [e for e in iter_events(text, strict=strict)
            if e["event"] == name]


def last_event(text: str, name: str) -> Optional[dict]:
    """The most recent event named ``name``, or None."""
    found = None
    for e in iter_events(text):
        if e["event"] == name:
            found = e
    return found
