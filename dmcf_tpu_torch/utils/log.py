"""Logging helpers: brace-format log records, run-id allocation, dir
utils (the port's copy of dmcf_tpu/utils/log.py)."""

import logging
import os
import re


class LogRecord(logging.LogRecord):
    """LogRecord that formats messages with str.format (brace style)."""

    def getMessage(self):
        msg = str(self.msg)
        if self.args:
            msg = msg.format(*self.args)
        return msg


def make_dir(path):
    os.makedirs(path, exist_ok=True)


def get_runid(path):
    """Next 5-digit run id for a summary directory family."""
    name = os.path.basename(path)
    parent = os.path.dirname(path) or "."
    if not os.path.exists(parent):
        return "00001"
    best = 0
    pattern = re.compile(r"^(\d{5})_" + re.escape(name) + r"$")
    for entry in os.listdir(parent):
        m = pattern.match(entry)
        if m:
            best = max(best, int(m.group(1)))
    return "%05d" % (best + 1)


def setup_logging():
    """Brace-format records and one INFO handler on the root logger
    (``force``: replaces handlers a library installed before)."""
    logging.setLogRecordFactory(LogRecord)
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s - %(asctime)s - %(module)s - %(message)s",
        force=True,
    )
