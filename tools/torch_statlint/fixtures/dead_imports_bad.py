"""Seeded violation for the dead-import check: an import nothing uses."""

import json
import os


def where() -> str:
    return os.getcwd()
