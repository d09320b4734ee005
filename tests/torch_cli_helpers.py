"""Helpers for tests of the port's command line (seld_tpu_torch.cli.main),
which logs to standard output beside what a command prints and turns an
exception into a logged "<command> failed" record and exit code 1."""

import json
import logging
import re

from seld_tpu_torch.cli import main as port_main

# a line of the package's log format: "2026-01-02 03:04:05 - seld_tpu_torch..."
LOG_LINE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d - seld_tpu_torch")


def printed_lines(text: str) -> list[str]:
    """The lines a command printed, without its log lines."""
    return [line for line in text.splitlines() if not LOG_LINE.match(line)]


def printed_json(text: str):
    """The JSON document a command printed among its log lines."""
    return json.loads("\n".join(printed_lines(text)))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def port_fails(argv: list[str], exc_type: type, match: str | None = None) -> BaseException:
    """Run the port's CLI on argv: it must return 1 and log "<command>
    failed" with an exception of exc_type whose message re.search-matches
    `match` (pytest.raises's rule). Returns the exception."""
    capture = _Records()
    log = logging.getLogger("seld_tpu_torch")
    log.addHandler(capture)
    try:
        rc = port_main(argv)
    finally:
        log.removeHandler(capture)
    assert rc == 1, f"rc {rc}"
    (failed,) = [r for r in capture.records if r.getMessage() == f"{argv[0]} failed"]
    exc = failed.exc_info[1]
    assert isinstance(exc, exc_type), repr(exc)
    if match is not None:
        assert re.search(match, str(exc)), f"{match!r} not in {str(exc)!r}"
    return exc
